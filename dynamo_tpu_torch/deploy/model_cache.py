"""DynamoTpuModelCache controller: pre-stage checkpoints via k8s Jobs.  The
port's copy of the JAX package's ``deploy/model_cache.py``: the fetch Job
runs the port's ``prepare`` (which resolves local and pre-staged
checkpoints only: the port downloads nothing, models/hub.py), with
``CUDA_VISIBLE_DEVICES=""`` in place of ``JAX_PLATFORMS=cpu``.

Reference counterpart: the operator's second controller half —
``dynamonimrequest_controller.go`` (1965 LoC) builds the ARTIFACT a
deployment consumes (a container image baked from a NIM request) before
serving starts.  The TPU-native analog of "build the artifact" is
"stage the checkpoint": serving pods resolve models from DYN_MODEL_CACHE
(models/hub.py), so this controller renders a batch/v1 Job that runs
``python -m dynamo_tpu_torch.cli prepare MODEL --cache <pvc mount>`` into a
shared PVC, and reports Pending/Running/Ready/Failed from the Job's
status — cold-start downloads move out of the serving path exactly the
way image builds do in the reference.

CR shape (deploy/k8s/modelcache-crd.yaml):

  apiVersion: dynamo.tpu.io/v1alpha1
  kind: DynamoTpuModelCache
  spec:
    model: deepseek-ai/DeepSeek-R1-Distill-Llama-8B   # alias/repo/path
    revision: main          # optional
    image: dynamo-tpu:latest
    pvc: model-cache        # PVC mounted at /models in the fetch Job
    path: /models           # optional mount path

Job names embed a short hash of (model, revision, image): editing the CR
spawns a fresh Job and the stale one is swept as an orphan — Jobs are
effectively immutable, so "update" is replace-by-name.
"""

from __future__ import annotations

import copy
import hashlib
import logging
from typing import Any, Dict, Optional

from .controller import MANAGER_LABEL, OWNER_LABEL, Reconciler

logger = logging.getLogger(__name__)

CACHE_CR_PLURAL = "dynamotpumodelcaches"


def _spec_hash(spec: Dict[str, Any]) -> str:
    key = "|".join(
        str(spec.get(k, "")) for k in ("model", "revision", "image", "pvc", "path")
    )
    return hashlib.sha256(key.encode()).hexdigest()[:10]


def _job_name(cr_name: str, spec: Dict[str, Any]) -> str:
    """``<cr>-fetch-<hash>``, truncated from the CR-name side so the hash
    (the spec identity) survives both the 253-char object-name limit and
    the 63-char label-value limit."""
    return f"{cr_name[:46]}-fetch-{_spec_hash(spec)}"


def render_fetch_job(cr: Dict[str, Any]) -> Dict[str, Any]:
    """batch/v1 Job staging ``spec.model`` into the PVC."""
    name = cr["metadata"]["name"]
    spec = cr.get("spec") or {}
    for req in ("model", "image", "pvc"):
        if not spec.get(req):
            raise ValueError(f"DynamoTpuModelCache {name!r} needs spec.{req}")
    mount = spec.get("path") or "/models"
    cmd = ["python", "-m", "dynamo_tpu_torch.cli", "prepare", spec["model"],
           "--cache", mount]
    if spec.get("revision"):
        cmd += ["--revision", str(spec["revision"])]
    job_name = _job_name(name, spec)
    labels = {
        "app.kubernetes.io/name": job_name,  # <=63 chars by construction
        OWNER_LABEL: name,
    }
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": job_name, "labels": labels,
                     "namespace": cr["metadata"].get("namespace", "default")},
        "spec": {
            "backoffLimit": 3,
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [
                        {
                            "name": "fetch",
                            "image": spec["image"],
                            "command": cmd,
                            "env": [{"name": "CUDA_VISIBLE_DEVICES", "value": ""}],
                            "volumeMounts": [
                                {"name": "cache", "mountPath": mount}
                            ],
                        }
                    ],
                    "volumes": [
                        {
                            "name": "cache",
                            "persistentVolumeClaim": {"claimName": spec["pvc"]},
                        }
                    ],
                },
            },
        },
    }


class ModelCacheReconciler(Reconciler):
    """Drives DynamoTpuModelCache CRs: one fetch Job per spec revision.

    Subclasses Reconciler for the manager-scoped teardown / orphan-sweep
    machinery (one implementation of the scoping rules — the r4 advisory
    semantics must not diverge between the two controllers); only
    ``reconcile`` and the child kind differ."""

    CHILD_KINDS = ("Job",)

    async def reconcile(self, cr: Dict[str, Any]) -> Dict[str, Any]:
        name = cr["metadata"]["name"]
        job = copy.deepcopy(render_fetch_job(cr))
        job["metadata"]["labels"][MANAGER_LABEL] = self.manager
        job["spec"]["template"]["metadata"]["labels"][MANAGER_LABEL] = self.manager
        want_name = job["metadata"]["name"]

        observed: Dict[str, Dict[str, Any]] = {}
        for m in await self.kube.list("Job", label=(OWNER_LABEL, name)):
            labels = m["metadata"].get("labels") or {}
            if labels.get(MANAGER_LABEL) not in (None, self.manager):
                continue
            observed[m["metadata"]["name"]] = m

        if want_name not in observed:
            await self.kube.apply(job)
        # Jobs from superseded specs (different hash): delete.
        for jname, m in observed.items():
            if jname != want_name:
                await self.kube.delete("Job", jname)

        status = self._status(observed.get(want_name))
        await self.kube.update_status(
            dict(cr, kind="DynamoTpuModelCache"), status
        )
        return status

    def _status(self, job: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        if job is None:
            return {"phase": "Pending"}
        js = job.get("status") or {}
        if js.get("succeeded"):
            return {"phase": "Ready"}
        # The authoritative terminal signal is the Failed CONDITION (the
        # pod-failure count at exhaustion can be <= backoffLimit due to
        # counting races; a hardcoded count threshold can stick at
        # Pending forever).
        for cond in js.get("conditions") or []:
            if cond.get("type") == "Failed" and cond.get("status") == "True":
                return {"phase": "Failed", "failed": js.get("failed", 0)}
        if js.get("active"):
            return {"phase": "Running"}
        return {"phase": "Pending"}

    # teardown(), sweep_orphans(), run_pass() and the watch-driven run()
    # are INHERITED from Reconciler with CHILD_KINDS=("Job",) and
    # CR_KIND="DynamoTpuModelCache" — one implementation of the
    # manager-scoping and watch/resync machinery.
    CR_KIND = "DynamoTpuModelCache"
