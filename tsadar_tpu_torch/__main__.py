"""``python -m tsadar_tpu_torch --cfg <dir> --mode {fit,forward,series} [--run_id ID] [--device cuda|cpu]``."""

from .cli import main

main()
