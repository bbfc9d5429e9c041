"""Command line: ``python -m tsadar_tpu_torch --cfg <dir> --mode {fit,forward,series}``.

Counterpart of ``tsadar_tpu.cli`` (``run_tsadar_tpu.py``).  ``--cfg`` names a
directory holding ``defaults.yaml`` and ``inputs.yaml``; ``--run_id`` resumes
a queued run instead (``runner.run_job``).  The run goes to the card unless
``--device cpu`` is given: with no GPU present, and no ``--device cpu``, the
command fails with ``device.resolve_device``'s message before any work.  A
run's files land under ``$TSADAR_RUNS_DIR`` (default ``./tsadar_runs``);
with ``MLFLOW_EXPORT`` set the finished run is exported for ingestion
(``utils.export.export_run``).  Under ``torchrun`` every rank runs this
command (``python -m torch.distributed.run --nproc_per_node N -m
tsadar_tpu_torch ...``): the process group spans the run and its export,
the ranks share the fit, and rank 0 writes and exports the run
(``utils.mlflow_shim.writer``).
"""

import argparse
import os


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run; returns the run's id."""
    from .device import resolve_device
    from .parallel import dist as par
    from .runner import run, run_job
    from .utils import mlflow_shim as mlflow
    from .utils.export import export_run

    parser = argparse.ArgumentParser(prog="python -m tsadar_tpu_torch",
                                     description="Thomson-scattering analysis in PyTorch on a CUDA GPU")
    parser.add_argument("--cfg", help="config directory containing defaults.yaml and inputs.yaml")
    parser.add_argument("--run_id", help="run id to resume (queued runs)")
    parser.add_argument("--mode", default="fit", help="fit, forward, or series")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the run goes: the GPU (default) or, when asked, the CPU in float64")
    args = parser.parse_args(argv)

    if args.run_id is None and args.cfg is None:
        parser.error("--cfg <config_dir> is required (or pass --run_id to resume a run)")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        parser.error(f"{e} (--device cpu)")

    with par.process_group(args.device):
        if args.run_id is not None:
            run_job(args.run_id, mode=args.mode, nested=False, device=args.device)
            run_id = args.run_id
        else:
            run_id = run(args.cfg, mode=args.mode, device=args.device)

        if "MLFLOW_EXPORT" in os.environ and mlflow.writer():
            export_run(run_id)
    return run_id


if __name__ == "__main__":
    main()
