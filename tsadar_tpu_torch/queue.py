"""SLURM submission of a run: ``python -m tsadar_tpu_torch.queue --cfg <dir> --mode fit [--machine gpu]``.

Counterpart of ``queue_tsadar_tpu.py``: registers the run with its decks as
artifacts (``runner.load_and_make_folders``), writes ``new_job.sh`` in the
working directory -- the base template named by ``GPU_BASE_JOB_FILE`` (or
``CPU_BASE_JOB_FILE`` for ``--machine cpu``) followed by
``srun python -m tsadar_tpu_torch --run_id <id> --mode <mode>`` -- and hands it
to ``sbatch``.  A CPU job runs the port with ``--device cpu``.
"""

import argparse
import os
import subprocess

from .runner import load_and_make_folders

BASE_JOB_FILES = {"cpu": "CPU_BASE_JOB_FILE", "gpu": "GPU_BASE_JOB_FILE"}


def load_and_queue(cfg_path, mode, machine="gpu"):
    """Register the run, write its job script and submit it: the run's id."""
    env_key = BASE_JOB_FILES[machine]
    base_job_file = os.environ.get(env_key)
    if base_job_file is None:
        raise EnvironmentError(f"{env_key} must point at a base SLURM job template")
    run_id, _ = load_and_make_folders(cfg_path)
    with open(base_job_file, "r") as fh:
        base_job = fh.read()
    device = " --device cpu" if machine == "cpu" else ""
    with open(os.path.join(os.getcwd(), "new_job.sh"), "w") as job_file:
        job_file.write(base_job)
        job_file.write(f"\nsrun python -m tsadar_tpu_torch --run_id {run_id} --mode {mode}{device}\n")
    subprocess.run(["sbatch", "new_job.sh"], check=True)
    return run_id


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tsadar_tpu_torch.queue", description="Queue a run through SLURM")
    parser.add_argument("--cfg", help="config directory")
    parser.add_argument("--mode", default="fit")
    parser.add_argument("--machine", default="gpu", choices=tuple(BASE_JOB_FILES))
    args = parser.parse_args(argv)
    print(load_and_queue(args.cfg, args.mode, args.machine))


if __name__ == "__main__":
    main()
