"""DynamoTpuDeployment → k8s manifests: the operator's reconcile logic as a
pure function.  The port's copy of the JAX package's ``deploy/renderer.py``:
the same CR (deploy/k8s/crd.yaml) renders into manifests that run the port
on NVIDIA GPUs.  Names, labels, annotations, services, env, ports, replicas
and ordering are the JAX renderer's; what differs:

- every command is ``python -m dynamo_tpu_torch.cli …``, and engine roles
  run ``out=torch``;
- a service's ``tpu`` block becomes ``nvidia.com/gpu`` requests and
  limits: a pod's local rank count (``tp*dp*ep*sp / nnodes``) when the
  engine runs more than one rank, else ``tpu.chips`` (default 1); and
  ``tpu.accelerator`` a ``nvidia.com/gpu.product`` node selector;
- ``tpu.topology`` (a TPU slice's shape) is refused, as is a mesh whose
  ranks do not split over ``nnodes`` and any engine flag the port's ``run``
  parser rejects: no manifest carries a flag its worker would refuse.

Reference counterpart: the k8s operator's child-resource generation
(deploy/dynamo/operator/*: a DynamoDeployment CR fans out into per-service
Deployments/Services with env wiring) and the helm chart's templates.  Here
the same mapping is a testable function — usable by an in-cluster controller
or from the CLI (``dynamo-tpu deploy render``) for GitOps-style flows.

Service roles map onto the CLI (cli.py):
  hub       → ``cli hub``                          (control plane)
  frontend  → ``cli http --hub … --router kv``     (OpenAI edge)
  worker    → ``cli run in=dyn://… out=torch``      (aggregated engine)
  prefill   → worker with ``--disagg prefill``
  decode    → worker with ``--disagg decode``
  router    → standalone KV router (via frontend flag today)
  metrics   → ``cli metrics``

Multi-host workers (nnodes > 1) render as the JAX renderer's: one
StatefulSet of nnodes pods, the node rank from the pod ordinal and rank 0's
pod DNS as the ``--coordinator`` (the process group's store); each pod's
``run`` starts its node's other local ranks itself.
"""

from __future__ import annotations

import contextlib
import io
import shlex
from typing import Any, Dict, List

HUB_PORT = 6650
HTTP_PORT = 8000
METRICS_PORT = 9091
STEP_PORT = 6651
COORD_PORT = 6652


def _meta(name: str, app: str, extra: Dict[str, str] = {}) -> Dict[str, Any]:
    return {
        "name": name,
        "labels": {"app.kubernetes.io/name": app,
                   "app.kubernetes.io/part-of": "dynamo-tpu", **extra},
    }


def _env_list(*groups) -> List[Dict[str, str]]:
    out: List[Dict[str, str]] = []
    for g in groups:
        out.extend(g or [])
    return out


def _engine_flags(engine: Dict[str, Any]) -> List[str]:
    flags = []
    for key, val in (engine or {}).items():
        flags.append(f"--{key.replace('_', '-')}")
        flags.append(str(val))
    return flags


def _check_worker(svc_name: str, svc: Dict[str, Any], cmd: List[str]) -> int:
    """Refuse a worker the port cannot run: a TPU topology, a mesh whose
    ranks do not split over its nodes, or a ``run`` command line the port's
    parser or engine factory rejects.  Returns the ranks one pod runs."""
    from ..cli import parse_args
    from ..engine import UNSUPPORTED_OPTIONS

    if (svc.get("tpu") or {}).get("topology"):
        raise ValueError(f"service {svc_name!r}: tpu.topology names a TPU slice; the port "
                         "runs on NVIDIA GPUs (give nnodes and the engine's tp/dp/ep/sp)")
    err = io.StringIO()
    # The pod ordinal is substituted at run time.
    argv = ["0" if a == "$(POD_ORDINAL)" else a for a in cmd[3:]]
    try:
        with contextlib.redirect_stderr(err):
            args = parse_args(argv)
    except SystemExit:
        said = (err.getvalue().strip().splitlines() or ["rejected"])[-1]
        raise ValueError(f"service {svc_name!r}: the port's run refuses "
                         f"{shlex.join(cmd[3:])!r}: {said}") from None
    for attr, default, flag, waits in UNSUPPORTED_OPTIONS:
        if getattr(args, attr) != default:
            raise ValueError(f"service {svc_name!r}: {flag} {getattr(args, attr)} is not "
                             f"supported by the port yet (ROADMAP {waits})")
    for axis in ("tp", "dp", "ep", "sp", "nnodes"):
        if getattr(args, axis) < 1:
            raise ValueError(f"service {svc_name!r}: --{axis} {getattr(args, axis)} must be >= 1")
    world = args.tp * args.dp * args.ep * args.sp
    if world % args.nnodes:
        raise ValueError(f"service {svc_name!r}: {world} ranks do not split over "
                         f"nnodes {args.nnodes}")
    return world // args.nnodes


def render(cr: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One DynamoTpuDeployment custom resource → child manifests."""
    name = cr["metadata"]["name"]
    namespace = cr["metadata"].get("namespace", "default")
    spec = cr["spec"]
    image = spec["image"]
    model = spec.get("model", "model")
    global_envs = spec.get("envs", [])
    out: List[Dict[str, Any]] = []
    hub_addr = f"{name}-hub.{namespace}.svc:{HUB_PORT}"

    services = spec.get("services") or {"hub": {"role": "hub"},
                                        "frontend": {"role": "frontend"},
                                        "worker": {"role": "worker"}}
    for svc_name, svc in services.items():
        role = svc.get("role", svc_name)
        full = f"{name}-{svc_name}"
        replicas = int(svc.get("replicas", 1))
        tpu = svc.get("tpu") or {}
        envs = _env_list(global_envs, svc.get("envs"))

        if role == "hub":
            cmd = ["python", "-m", "dynamo_tpu_torch.cli", "hub",
                   "--port", str(HUB_PORT)]
            out.append(_deployment(full, namespace, image, cmd, replicas,
                                   envs, port=HUB_PORT))
            out.append(_service(full, namespace, HUB_PORT))
            continue
        if role == "frontend":
            cmd = ["python", "-m", "dynamo_tpu_torch.cli", "http", "--hub", hub_addr,
                   "--port", str(HTTP_PORT), "--router",
                   str(svc.get("engine", {}).get("router", "kv"))]
            out.append(_deployment(full, namespace, image, cmd, replicas,
                                   envs, port=HTTP_PORT))
            out.append(_service(full, namespace, HTTP_PORT))
            ing = svc.get("ingress")
            if ing is not None:  # {} is an error (host required), not "off"
                # External exposure for the OpenAI edge (reference operator
                # renders ingress/virtual-service objects for its frontend;
                # dynamocomponent_controller.go ingress half).
                out.append(_ingress(full, namespace, HTTP_PORT, ing))
            continue
        if role == "metrics":
            cmd = ["python", "-m", "dynamo_tpu_torch.cli", "metrics", "--hub",
                   hub_addr, "--port", str(METRICS_PORT)]
            out.append(_deployment(full, namespace, image, cmd, replicas,
                                   envs, port=METRICS_PORT))
            out.append(_service(full, namespace, METRICS_PORT))
            continue

        # engine roles: worker / prefill / decode
        endpoint = f"dyn://dynamo.TpuWorker.{svc_name}"
        cmd = ["python", "-m", "dynamo_tpu_torch.cli", "run", f"in={endpoint}",
               "out=torch", "--hub", hub_addr, "--model", model]
        if spec.get("checkpoint"):
            cmd += ["--checkpoint", spec["checkpoint"]]
        if role in ("prefill", "decode"):
            cmd += ["--disagg", role]
        cmd += _engine_flags(svc.get("engine"))
        nnodes = int(svc.get("nnodes", 1))
        if nnodes > 1:
            # Pod ordinal = node rank; rank 0's pod DNS is the coordinator.
            coord = f"{full}-0.{full}.{namespace}.svc:{COORD_PORT}"
            cmd += ["--nnodes", str(nnodes), "--coordinator", coord,
                    "--step-port", str(STEP_PORT),
                    "--node-rank", "$(POD_ORDINAL)"]
            envs = envs + [{
                "name": "POD_ORDINAL",
                "valueFrom": {"fieldRef": {
                    "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"
                }},
            }]
        local = _check_worker(svc_name, svc, cmd)
        if tpu and local > 1:
            tpu = {**tpu, "chips": local}  # one card per local rank
        out.append(_statefulset(full, namespace, image, cmd,
                                replicas=nnodes if nnodes > 1 else replicas,
                                envs=envs, tpu=tpu))
        out.append(_service(full, namespace, STEP_PORT, headless=True))
    return out


def _container(name: str, image: str, cmd: List[str], envs, tpu=None,
               port=None) -> Dict[str, Any]:
    c: Dict[str, Any] = {
        "name": name,
        "image": image,
        "command": cmd,
        "env": envs,
    }
    if port is not None:
        c["ports"] = [{"containerPort": port}]
    if tpu:
        gpus = int(tpu.get("chips", 1))
        c["resources"] = {"limits": {"nvidia.com/gpu": gpus},
                          "requests": {"nvidia.com/gpu": gpus}}
    return c


def _deployment(name, namespace, image, cmd, replicas, envs, port=None):
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {**_meta(name, name), "namespace": namespace},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app.kubernetes.io/name": name}},
            "template": {
                "metadata": _meta(name, name),
                "spec": {"containers": [
                    _container(name, image, cmd, envs, port=port)
                ]},
            },
        },
    }


def _statefulset(name, namespace, image, cmd, replicas, envs, tpu):
    pod_spec: Dict[str, Any] = {
        "containers": [_container(name, image, cmd, envs, tpu=tpu)],
    }
    if tpu.get("accelerator"):
        pod_spec["nodeSelector"] = {"nvidia.com/gpu.product": tpu["accelerator"]}
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {**_meta(name, name), "namespace": namespace},
        "spec": {
            "serviceName": name,
            "replicas": replicas,
            "podManagementPolicy": "Parallel",  # all ranks start together
            "selector": {"matchLabels": {"app.kubernetes.io/name": name}},
            "template": {
                "metadata": _meta(name, name),
                "spec": pod_spec,
            },
        },
    }


def _service(name, namespace, port, headless=False):
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {**_meta(name, name), "namespace": namespace},
        "spec": {
            "selector": {"app.kubernetes.io/name": name},
            "ports": [{"port": port, "targetPort": port}],
        },
    }
    if headless:
        svc["spec"]["clusterIP"] = "None"
    return svc


def _ingress(name, namespace, port, ing: Dict[str, Any]):
    """networking.k8s.io/v1 Ingress for a frontend Service.

    ``ing``: {host: str (required), className: str?, path: str?,
    tlsSecret: str?, annotations: {...}?}."""
    host = ing.get("host")
    if not host:
        raise ValueError("frontend ingress needs a 'host'")
    meta = {**_meta(name, name), "namespace": namespace}
    user_ann = dict(ing.get("annotations") or {})
    # Owned-keys marker: the drift check (_spec_equal) compares desired vs
    # observed by SUBSET, so REMOVING an annotation from the CR would
    # otherwise never re-apply (the smaller set still subsets the live
    # object).  Encoding the owned key list in an annotation makes a
    # removal change the marker value → drift → server-side apply, which
    # then drops the removed key (this fieldManager owns it).
    user_ann["dynamo.tpu.io/owned-annotations"] = ",".join(sorted(user_ann))
    meta["annotations"] = user_ann
    spec: Dict[str, Any] = {
        "rules": [
            {
                "host": host,
                "http": {
                    "paths": [
                        {
                            "path": ing.get("path", "/"),
                            "pathType": "Prefix",
                            "backend": {
                                "service": {
                                    "name": name,
                                    "port": {"number": port},
                                }
                            },
                        }
                    ]
                },
            }
        ]
    }
    if ing.get("className"):
        spec["ingressClassName"] = ing["className"]
    if ing.get("tlsSecret"):
        spec["tls"] = [{"hosts": [host], "secretName": ing["tlsSecret"]}]
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "Ingress",
        "metadata": meta,
        "spec": spec,
    }


def render_to_yaml(cr: Dict[str, Any]) -> str:
    yaml = require_yaml()

    docs = render(cr)
    return "---\n".join(yaml.safe_dump(d, sort_keys=False) for d in docs)


def require_yaml():
    """PyYAML, or an error naming it: the port reads and writes CR YAML only
    through it."""
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "reading and writing deployment YAML needs the `yaml` package "
            "(PyYAML), which is not installed"
        ) from None
    return yaml


def shell_preview(cr: Dict[str, Any]) -> str:
    """The commands each service runs (docs / dry-run aid)."""
    lines = []
    for doc in render(cr):
        if doc["kind"] in ("Deployment", "StatefulSet"):
            c = doc["spec"]["template"]["spec"]["containers"][0]
            lines.append(f"# {doc['metadata']['name']}")
            lines.append(" ".join(shlex.quote(x) for x in c["command"]))
    return "\n".join(lines)
