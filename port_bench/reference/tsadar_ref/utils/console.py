"""Library diagnostics logger (stderr-backed), a copy of ``tsadar_tpu.utils.console``.

Every informational message the port emits while running (dewarp status,
dropped lineouts, ...) goes through ``log_info`` so that stdout stays
machine-clean: scripts such as ``chip_smoke.py`` print JSON lines there.
The handler writes bare messages to stderr (no level/name prefixes); callers
that want the standard ``logging`` machinery can configure the
``tsadar_tpu_torch`` logger themselves before first use.
"""

import logging
import sys

logger = logging.getLogger("tsadar_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def log_info(msg: str) -> None:
    """Emit a user-facing diagnostic line (stderr, not stdout)."""
    logger.info(msg)
