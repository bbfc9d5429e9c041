"""Run export for the hosted app's ingestion, a copy of ``tsadar_tpu.utils.export``.

``export_run`` writes a finished run (its metadata and artifacts) into a
directory tree and uploads it under ``artifacts/<run_id>/`` in a staging
bucket, then a marker ``<prefix>-<run_id>-<step>.txt`` whose body is
``ready``: the marker is what the ingestor polls for.  The run is read from
MLflow when it can be imported, else from the file-backed tracker
(``mlflow_shim``); the upload goes through boto3 when it can be imported,
else into the same key layout under ``$TSADAR_S3_STAGING_DIR/<bucket>/``
(default ``./s3_staging``).
"""

import json
import os
import shutil
import tempfile
import time

from . import mlflow_shim as mlflow
from .console import log_info

DEFAULT_BUCKET = "remote-mlflow-staging"


def upload_dir_to_s3(local_directory, bucket, destination, run_id, prefix="ingest", step=0):
    """Upload a directory tree to ``bucket`` under ``destination``, keeping its structure, then the marker."""
    try:
        import boto3

        client = boto3.client("s3")
        put = lambda local, key: client.upload_file(local, bucket, key)  # noqa: E731
    except ImportError:
        staging = os.environ.get("TSADAR_S3_STAGING_DIR", os.path.join(os.getcwd(), "s3_staging"))
        root = os.path.join(staging, bucket)

        def put(local, key):
            dst = os.path.join(root, key)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(local, dst)

    for walk_root, _, files in os.walk(local_directory):
        for filename in files:
            local_path = os.path.join(walk_root, filename)
            put(local_path, os.path.join(destination, os.path.relpath(local_path, local_directory)))

    marker = f"{prefix}-{run_id}-{step}.txt"
    marker_path = os.path.join(local_directory, marker)
    with open(marker_path, "w") as fi:
        fi.write("ready")
    put(marker_path, marker)


def _export_run_dir(run_id, out_dir):
    """The run's metadata (``run.json``) and artifacts, written under ``out_dir``."""
    if mlflow.HAVE_MLFLOW:
        import mlflow as _mlflow

        run = _mlflow.MlflowClient().get_run(run_id)
        info = {"run_id": run_id, "params": dict(run.data.params), "metrics": dict(run.data.metrics),
                "tags": dict(run.data.tags)}
        artifact_src = _mlflow.artifacts.download_artifacts(run_id=run_id)
    else:
        run_dir = mlflow._find_run_dir(run_id)
        if run_dir is None:
            raise FileNotFoundError(f"run {run_id} not found under the file-backed tracker")
        with open(os.path.join(run_dir, "run.json")) as fi:
            info = {"run_id": run_id, **json.load(fi)}
        artifact_src = os.path.join(run_dir, "artifacts")

    with open(os.path.join(out_dir, "run.json"), "w") as fi:
        json.dump(info, fi, indent=1, default=str)
    if os.path.isdir(artifact_src):
        shutil.copytree(artifact_src, os.path.join(out_dir, "artifacts"), dirs_exist_ok=True)


def export_run(run_id, prefix="ingest", step=0, bucket=DEFAULT_BUCKET):
    """Export run ``run_id`` and upload it under ``artifacts/<run_id>/`` in ``bucket``."""
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.getenv("BASE_TEMPDIR")) as td:
        _export_run_dir(run_id, td)
        log_info(f"Export took {round(time.time() - t0, 2)} s")
        t0 = time.time()
        upload_dir_to_s3(td, bucket, f"artifacts/{run_id}", run_id, prefix=prefix, step=step)
    log_info(f"Uploading took {round(time.time() - t0, 2)} s")
