"""The port's deployment tooling (``dynamo_tpu_torch/deploy``) against the JAX
package's (``tests/test_deploy.py``, ``tests/test_kube_api.py``,
``tests/test_model_cache.py``):

- the renderer: the repository's ``deploy/k8s/example-deployment.yaml`` (a
  v5e pod: ``nnodes: 4``, ``topology: 4x4``, ``tp: 4``) is refused for its
  TPU topology, as are a mesh axis below 1, ranks that do not split over
  ``nnodes`` and any flag the port's ``run`` rejects; a single-card variant built here, the
  JAX tests' CRs cut to one card, and a frontend ingress render to the JAX
  output after the documented substitutions (``dynamo_tpu_torch.cli``,
  ``out=torch``, ``nvidia.com/gpu`` resources and ``gpu.product`` node
  selector); ``render_to_yaml`` and ``shell_preview`` alike;
- the ``Reconciler`` over each package's ``FakeKube``: the same applies,
  deletes, objects (substituted) and statuses through create, drift,
  update, the orphan sweep and the manager scoping;
- ``KubeApi`` on the standard library through ``tests/test_kube_api.py``'s
  cases against its fake API server (SSA apply, label-selector list,
  delete, the token refresh, the status-subresource fallback and its
  warning, the Reconciler over HTTP, a watch event triggering a pass
  before the resync), on each package;
- the model cache: the fetch Job (substituted: ``dynamo_tpu_torch.cli
  prepare`` and ``CUDA_VISIBLE_DEVICES=""``) and the reconciler's statuses
  through a Job's life alike;
- the api-store: the same statuses, content types, ``Allow`` headers and
  bodies byte for byte for the same requests on each package's store,
  with and without a bearer token, a reconciler attached.
"""

import asyncio
import copy
import http.client
import importlib
import json
import logging
import os
import sys
import types

import pytest
import yaml

from test_kube_api import MockApiServer, _sa_dir  # the JAX tests' fake API server

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "deploy", "k8s", "example-deployment.yaml")


def D(pkg):
    m = lambda sub: importlib.import_module(f"{pkg}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        deploy=m("deploy"), renderer=m("deploy.renderer"), controller=m("deploy.controller"),
        model_cache=m("deploy.model_cache"), api_store=m("deploy.api_store"),
        hub=m("runtime.transports.hub"),
    )


_TOKENS = {"dynamo_tpu.cli": "dynamo_tpu_torch.cli", "out=tpu": "out=torch"}
_KEYS = {"google.com/tpu": "nvidia.com/gpu",
         "cloud.google.com/gke-tpu-accelerator": "nvidia.com/gpu.product"}


def substituted(obj):
    """A JAX manifest as the port renders it (the renderer's and the model
    cache's documented substitutions)."""
    if isinstance(obj, dict):
        out = {_KEYS.get(k, k): substituted(v) for k, v in obj.items()}
        if out.get("name") == "JAX_PLATFORMS" and out.get("value") == "cpu":
            out = {"name": "CUDA_VISIBLE_DEVICES", "value": ""}
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(substituted(v) for v in obj)
    if isinstance(obj, str):
        return _TOKENS.get(obj, obj)
    return obj


def _one_card(cr):
    """The example CR cut to what one card serves: no multi-host, no
    topology, tp 1, one chip per worker."""
    cr = copy.deepcopy(cr)
    for svc in cr["spec"]["services"].values():
        svc.pop("nnodes", None)
        if "tpu" in svc:
            svc["tpu"] = {"accelerator": svc["tpu"]["accelerator"], "chips": 1}
        if "tp" in (svc.get("engine") or {}):
            svc["engine"] = {k: v for k, v in svc["engine"].items() if k not in ("tp", "dp")}
            svc["engine"]["tp"] = 1
    return cr


def _example():
    with open(EXAMPLE) as f:
        return yaml.safe_load(f)


def _mini_cr(name="app", services=None, generation=1):
    return {
        "apiVersion": "dynamo.tpu.io/v1alpha1",
        "kind": "DynamoTpuDeployment",
        "metadata": {"name": name, "generation": generation},
        "spec": {
            "image": "dynamo-tpu:latest",
            "model": "tiny",
            "services": services or {
                "hub": {"role": "hub"},
                "frontend": {"role": "frontend"},
                "worker": {"role": "worker", "replicas": 2},
            },
        },
    }


RENDER_CRS = {
    "example-one-card": _one_card(_example()),
    "mini": _mini_cr(),
    "test_deploy-one-card": {
        "apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuDeployment",
        "metadata": {"name": "demo", "namespace": "serving"},
        "spec": {
            "image": "img:1", "model": "m8b", "checkpoint": "/models/m8b",
            "envs": [{"name": "DYN_LOG", "value": "info"}],
            "services": {
                "hub": {"role": "hub"},
                "frontend": {"role": "frontend", "replicas": 2,
                             "ingress": {"host": "x.example.com", "className": "nginx",
                                         "tlsSecret": "t", "annotations": {"a": "b"}}},
                "metrics": {"role": "metrics"},
                "decode": {"role": "decode", "tpu": {"accelerator": "h100", "chips": 1},
                           "engine": {"max_batch": 64, "block-size": 32},
                           "envs": [{"name": "X", "value": "1"}]},
                "prefill": {"role": "prefill", "replicas": 2, "tpu": {"chips": 2}},
                "worker": {"role": "worker", "tpu": {}},
            },
        },
    },
    "default-services": {"metadata": {"name": "d"}, "spec": {"image": "i"}},
}


@pytest.mark.parametrize("case", sorted(RENDER_CRS))
def test_render_equals_jax_after_substitution(case):
    cr = RENDER_CRS[case]
    port, jax = D(PORT).deploy, D(JAX).deploy
    assert port.render(cr) == substituted(jax.render(cr))


def _yaml_docs(text):
    return list(yaml.safe_load_all(text))


@pytest.mark.parametrize("case", sorted(RENDER_CRS))
def test_yaml_and_preview_equal_jax_after_substitution(case):
    cr = RENDER_CRS[case]
    port, jax = D(PORT).deploy, D(JAX).deploy
    assert _yaml_docs(port.render_to_yaml(cr)) == substituted(_yaml_docs(jax.render_to_yaml(cr)))
    want = jax.shell_preview(cr).replace("dynamo_tpu.cli", "dynamo_tpu_torch.cli")
    assert port.shell_preview(cr) == want.replace(" out=tpu ", " out=torch ")


def test_gpu_resources_default_to_one_card():
    docs = D(PORT).deploy.render(RENDER_CRS["test_deploy-one-card"])
    by = {d["metadata"]["name"]: d for d in docs if d["kind"] == "StatefulSet"}
    c = by["demo-worker"]["spec"]["template"]["spec"]["containers"][0]
    assert "resources" not in c  # an empty tpu block asks for nothing, as on JAX
    pod = by["demo-decode"]["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"] == {"limits": {"nvidia.com/gpu": 1},
                                                 "requests": {"nvidia.com/gpu": 1}}
    assert pod["nodeSelector"] == {"nvidia.com/gpu.product": "h100"}
    cr = copy.deepcopy(RENDER_CRS["test_deploy-one-card"])
    cr["spec"]["services"]["decode"]["tpu"] = {"accelerator": "h100"}
    pod = {d["metadata"]["name"]: d for d in D(PORT).deploy.render(cr)
           if d["kind"] == "StatefulSet"}["demo-decode"]
    assert pod["spec"]["template"]["spec"]["containers"][0]["resources"]["limits"] == {
        "nvidia.com/gpu": 1}


def test_example_cr_is_refused_naming_item_7():
    """Multi-host serving is in the port; the example's TPU topology is
    still refused (the multi-host render itself: test_torch_multihost.py)."""
    cr = _example()
    with pytest.raises(ValueError, match=r"tpu.topology names a TPU slice"):
        D(PORT).deploy.render(cr)
    assert any(d["kind"] == "StatefulSet" for d in D(JAX).deploy.render(cr))


REFUSED = {
    "tp": ({"engine": {"tp": 0}}, r"--tp 0 must be >= 1"),
    "dp": ({"engine": {"dp": 3}, "nnodes": 2}, r"3 ranks do not split over nnodes 2"),
    "ep": ({"engine": {"ep": 0}}, r"--ep 0 must be >= 1"),
    "topology": ({"tpu": {"accelerator": "a", "topology": "4x4"}}, r"topology names a TPU slice"),
    "nnodes": ({"nnodes": 2}, r"1 ranks do not split over nnodes 2"),
    "unknown-flag": ({"engine": {"attn_impl": "xla"}}, r"unrecognized arguments: --attn-impl"),
    "bad-value": ({"engine": {"max_batch": "many"}}, r"--max-batch: invalid int value"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_worker_the_port_cannot_run_is_refused(case):
    extra, match = REFUSED[case]
    cr = _mini_cr(services={"hub": {"role": "hub"}, "decode": {"role": "decode", **extra}})
    with pytest.raises(ValueError, match=match):
        D(PORT).deploy.render(cr)
    D(JAX).deploy.render(cr)  # the JAX renderer maps it


def test_yaml_is_required_and_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match=r"PyYAML"):
        D(PORT).deploy.render_to_yaml(_mini_cr())
    assert "hub" in D(PORT).deploy.shell_preview(_mini_cr())


# ---------------------------------------------------------------- controller


async def _lifecycle(pkg):
    """tests/test_deploy.py's create → idempotent → drift → update → sweep
    cycle, then the manager scoping; everything observable, in order."""
    C = D(pkg).controller
    kube = C.FakeKube()
    rec = C.Reconciler(kube)
    log = []
    cr = _mini_cr()
    kube.objects[("DynamoTpuDeployment", "app")] = cr
    log.append(("create", await rec.reconcile(cr), list(kube.applied)))
    kube.applied.clear()
    log.append(("again", await rec.reconcile(cr), list(kube.applied)))
    await kube.delete("StatefulSet", "app-worker")
    kube.deleted.clear()
    log.append(("drift", await rec.reconcile(cr), list(kube.applied), list(kube.deleted)))
    kube.objects[("StatefulSet", "app-worker")]["spec"]["template"]["spec"]["dnsPolicy"] = "x"
    kube.applied.clear()
    log.append(("server-defaults", await rec.reconcile(cr), list(kube.applied)))
    cr2 = _mini_cr(services={"hub": {"role": "hub"}, "frontend": {"role": "frontend",
                                                                  "replicas": 3}}, generation=2)
    kube.objects[("DynamoTpuDeployment", "app")].update(cr2)
    kube.applied.clear()
    kube.deleted.clear()
    log.append(("update", await rec.reconcile(cr2), list(kube.applied), sorted(kube.deleted)))
    log.append(("objects", {f"{k}/{n}": m for (k, n), m in sorted(kube.objects.items())}))
    other = C.Reconciler(kube, manager="api-store")
    log.append(("other-teardown", await other.teardown("app")))
    del kube.objects[("DynamoTpuDeployment", "app")]
    kube.deleted.clear()
    log.append(("sweep", await rec.sweep_orphans(set()), sorted(kube.deleted)))
    slow = C.FakeKube(auto_ready=False)
    log.append(("progressing", await C.Reconciler(slow).reconcile(_mini_cr())))
    return log


def test_reconciler_applies_what_jax_applies():
    got = {pkg: asyncio.run(_lifecycle(pkg)) for pkg in PKGS}
    assert got[PORT] == substituted(got[JAX])
    assert got[PORT][0][1]["phase"] == "Ready" and got[PORT][-1][1]["phase"] == "Progressing"


def test_constants_and_labels_match_jax():
    P, J = D(PORT).controller, D(JAX).controller
    for name in ("GROUP", "OWNER_LABEL", "MANAGER_LABEL", "CR_PLURAL"):
        assert getattr(P, name) == getattr(J, name)
    assert P.KubeApi._PATHS == J.KubeApi._PATHS
    assert P.Reconciler.CHILD_KINDS == J.Reconciler.CHILD_KINDS
    from dynamo_tpu_torch.planner import actuate

    assert actuate.GROUP == J.GROUP


# ---------------------------------------------------- KubeApi over HTTP


def _kube_cr(name="app"):
    return {"apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuDeployment",
            "metadata": {"name": name},
            "spec": {"image": "img:1", "services": {"hub": {"role": "hub"}}}}


def _deployment(name, label, replicas):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "labels": {"a": label}}, "spec": {"replicas": replicas}}


@pytest.mark.parametrize("pkg", PKGS)
def test_kube_api_ssa_list_delete_and_token_refresh(tmp_path, monkeypatch, pkg):
    C = D(pkg).controller

    async def main():
        server = await MockApiServer().start()
        monkeypatch.setattr(C.KubeApi, "SA", _sa_dir(tmp_path, "tok-1"))
        kube = C.KubeApi(namespace="ns1", base=f"http://127.0.0.1:{server.port}")
        await kube.apply(_deployment("d1", "x", 2))
        await kube.apply(_deployment("d2", "y", 1))
        assert len(await kube.list("Deployment")) == 2
        sel = await kube.list("Deployment", label=("a", "x"))
        assert [m["metadata"]["name"] for m in sel] == ["d1"]
        server.objects[("deployments", "d1")]["status"] = {"readyReplicas": 2}
        await kube.apply(_deployment("d1", "x", 2))
        assert server.objects[("deployments", "d1")]["status"] == {"readyReplicas": 2}
        await kube.apply(_kube_cr())
        await kube.update_status(_kube_cr(), {"phase": "Ready"})
        assert server.objects[("dynamotpudeployments", "app")]["status"] == {"phase": "Ready"}
        (tmp_path / "sa" / "token").write_text("tok-2")
        server.expected_token = "tok-2"
        assert len(await kube.list("Deployment")) == 2
        assert server.tokens_seen[-1] == "tok-2"
        assert await kube.delete("Deployment", "d2") is True
        assert await kube.delete("Deployment", "gone") is False
        assert len(await kube.list("Deployment")) == 1
        server.expected_token = "tok-3"  # the next request is refused
        with pytest.raises(Exception):
            await kube.list("Deployment")
        await kube.close()
        await server.close()

    asyncio.run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_kube_api_status_fallback_without_subresource(tmp_path, monkeypatch, caplog, pkg):
    C = D(pkg).controller

    async def main():
        server = await MockApiServer(status_subresource=False).start()
        monkeypatch.setattr(C.KubeApi, "SA", _sa_dir(tmp_path, "tok-1"))
        kube = C.KubeApi(namespace="ns1", base=f"http://127.0.0.1:{server.port}")
        await kube.apply(_kube_cr())
        await kube.update_status(_kube_cr(), {"phase": "Progressing"})
        assert server.objects[("dynamotpudeployments", "app")]["status"] == {
            "phase": "Progressing"}
        del server.objects[("dynamotpudeployments", "app")]
        with caplog.at_level(logging.WARNING, logger=f"{pkg}.deploy.controller"):
            await kube.update_status(_kube_cr(), {"phase": "Ready"})
        return [r.getMessage() for r in caplog.records if "status write failed" in r.getMessage()]

    msgs = asyncio.run(main())
    assert msgs == ["status write failed for app: HTTP 404 via subresource (HTTP 404) and "
                    "merge-patch fallback"]


def test_reconciler_drives_real_http_surface(tmp_path, monkeypatch):
    """The Reconciler over each package's KubeApi against the fake API
    server: the same objects (substituted), labels, status and teardown."""

    async def main(C):
        server = await MockApiServer().start()
        monkeypatch.setattr(C.KubeApi, "SA", _sa_dir(tmp_path, "tok-1"))
        kube = C.KubeApi(namespace="ns1", base=f"http://127.0.0.1:{server.port}")
        cr = _kube_cr()
        server.objects[("dynamotpudeployments", "app")] = cr
        rec = C.Reconciler(kube)
        status = await rec.reconcile(cr)
        objects = {f"{k}/{n}": copy.deepcopy(m) for (k, n), m in sorted(server.objects.items())}
        deleted = await rec.teardown("app")
        await kube.close()
        await server.close()
        return status, objects, deleted

    got = {pkg: asyncio.run(main(D(pkg).controller)) for pkg in PKGS}
    assert got[PORT] == substituted(got[JAX])
    status, objects, deleted = got[PORT]
    assert status["totalServices"] == 1 and deleted >= 1
    labels = objects["deployments/app-hub"]["metadata"]["labels"]
    assert labels["dynamo.tpu.io/owner"] == "app"
    assert labels["dynamo.tpu.io/managed-by"] == "operator"


@pytest.mark.parametrize("pkg", PKGS)
def test_watch_triggers_reconcile_before_resync(tmp_path, monkeypatch, pkg):
    C = D(pkg).controller

    async def main():
        server = await MockApiServer().start()
        monkeypatch.setattr(C.KubeApi, "SA", _sa_dir(tmp_path, "tok-1"))
        kube = C.KubeApi(namespace="ns1", base=f"http://127.0.0.1:{server.port}")
        task = asyncio.create_task(C.Reconciler(kube).run(poll_interval=60.0))
        try:
            for _ in range(100):
                if server.watch_streams:
                    break
                await asyncio.sleep(0.05)
            assert server.watch_streams >= 1
            cr = _kube_cr()
            server.objects[("dynamotpudeployments", "app")] = cr
            # A large event: the stream splits lines across chunks.
            await server.watch_events.put({"type": "BOOKMARK", "object": {"pad": "x" * 300000}})
            await server.watch_events.put({"type": "ADDED", "object": cr})
            for _ in range(100):
                if any(pl == "deployments" for pl, _ in server.objects):
                    break
                await asyncio.sleep(0.05)
            names = {n for (pl, n) in server.objects if pl == "deployments"}
            assert "app-hub" in names  # long before the 60 s resync
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            await kube.close()
            # The cancel closed the stream's socket: the server's next
            # write fails and its watch handler returns, so the server
            # closes without waiting out its shutdown timeout.
            for _ in range(2):
                await server.watch_events.put({"type": "BOOKMARK"})
                await asyncio.sleep(0.05)
            await server.close()

    asyncio.run(main())


# ---------------------------------------------------------------- model cache


def _cache_cr(model="org/m", pvc="model-cache", **kw):
    return {"apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuModelCache",
            "metadata": {"name": "r1"},
            "spec": {"model": model, "image": "dynamo-tpu:latest", "pvc": pvc, **kw}}


async def _cache_lifecycle(pkg):
    M, C = D(pkg).model_cache, D(pkg).controller
    kube = C.FakeKube(auto_ready=False)
    rec = M.ModelCacheReconciler(kube)
    cr = _cache_cr(revision="v2", path="/cache")
    kube.objects[("DynamoTpuModelCache", "r1")] = cr
    log = [M.render_fetch_job(cr), await rec.reconcile(cr)]
    (job_name,) = [n for (k, n) in kube.objects if k == "Job"]
    for js in ({"active": 1}, {"failed": 1, "active": 1},
               {"failed": 4, "conditions": [{"type": "Failed", "status": "True"}]},
               {"succeeded": 1}):
        kube.objects[("Job", job_name)]["status"] = js
        log.append(await rec.reconcile(cr))
    cr2 = _cache_cr(model="org/other")
    kube.objects[("DynamoTpuModelCache", "r1")] = cr2
    log.append(await rec.reconcile(cr2))
    log.append(sorted(kube.deleted))
    log.append(copy.deepcopy(kube.objects[("DynamoTpuModelCache", "r1")]))
    del kube.objects[("DynamoTpuModelCache", "r1")]
    log.append(await rec.sweep_orphans(set()))
    with pytest.raises(ValueError, match="spec.pvc"):
        M.render_fetch_job(_cache_cr(pvc=""))
    return log


def test_model_cache_equals_jax_after_substitution():
    got = {pkg: asyncio.run(_cache_lifecycle(pkg)) for pkg in PKGS}
    assert got[PORT] == substituted(got[JAX])
    job = got[PORT][0]
    c = job["spec"]["template"]["spec"]["containers"][0]
    assert c["command"][:5] == ["python", "-m", "dynamo_tpu_torch.cli", "prepare", "org/m"]
    assert c["env"] == [{"name": "CUDA_VISIBLE_DEVICES", "value": ""}]
    assert [s["phase"] for s in got[PORT][1:6]] == ["Pending", "Running", "Running", "Failed",
                                                     "Ready"]


# ------------------------------------------------------------------ api-store

SPEC = {"name": "app", "image": "img:1",
        "services": {"hub": {"role": "hub"}, "worker": {"role": "worker"}}}
STORE_REQUESTS = [
    ("POST", "/api/v1/deployments", json.dumps(SPEC)),
    ("POST", "/api/v1/deployments", json.dumps(SPEC)),
    ("POST", "/api/v1/deployments", json.dumps({"metadata": {"name": "full"}, "spec": {
        "image": "i", "services": {"hub": {"role": "hub"}}}})),
    ("POST", "/api/v1/deployments", "{bad"),
    ("POST", "/api/v1/deployments", ""),
    ("POST", "/api/v1/deployments", json.dumps({"image": "x"})),
    ("POST", "/api/v1/deployments", json.dumps({"name": "a/b", "image": "x"})),
    ("POST", "/api/v1/deployments", json.dumps({"name": "bad"})),
    ("POST", "/api/v1/deployments", "[1]"),
    ("POST", "/api/v1/deployments", json.dumps({"name": 5})),
    ("GET", "/api/v1/deployments", None),
    ("GET", "/api/v1/deployments/app", None),
    ("GET", "/api/v1/deployments/zzz", None),
    ("GET", "/api/v1/deployments/zzz/manifests", None),
    ("PUT", "/api/v1/deployments", None),
    ("PATCH", "/api/v1/deployments/app", None),
    ("POST", "/api/v1/deployments/app/manifests", None),
    ("GET", "/nope", None),
    ("GET", "/api/v1/deployments/", None),
    ("GET", "/api/v1/deployments/a/b/c", None),
    ("GET", "/api/v1/deployments/a%20b", None),
    ("HEAD", "/api/v1/deployments", None),
    ("GET", "/api/v1/deployments?x=1", None),
    ("DELETE", "/api/v1/deployments/app", None),
    ("DELETE", "/api/v1/deployments/app", None),
    ("GET", "/api/v1/deployments", None),
]


def _call(port, method, path, body, headers):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=body, headers=headers)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.getheader("Allow"), r.read()
    finally:
        c.close()


async def _store_answers(pkg, token, headers):
    X = D(pkg)
    kube = X.controller.FakeKube()
    hub = await X.hub.InprocHub().start()
    store = await X.api_store.ApiStore(hub, X.controller.Reconciler(kube), host="127.0.0.1",
                                       port=0, token=token).start()
    try:
        out = []
        for method, path, body in STORE_REQUESTS:
            out.append(await asyncio.to_thread(_call, store.port, method, path, body, headers))
        out.append(await asyncio.to_thread(_call, store.port, "GET",
                                           "/api/v1/deployments/full/manifests", None, headers))
        return out, sorted(kube.applied), sorted(kube.deleted)
    finally:
        await store.close()
        await hub.close()


@pytest.mark.parametrize("auth", ["open", "no-token", "wrong-token", "token"])
def test_api_store_answers_byte_for_byte(auth):
    token = None if auth == "open" else "s3cret"
    headers = {"wrong-token": {"Authorization": "Bearer wrong"},
               "token": {"Authorization": "Bearer s3cret"}}.get(auth, {})
    got = {pkg: asyncio.run(_store_answers(pkg, token, headers)) for pkg in PKGS}
    port, jax = got[PORT], got[JAX]
    # The manifests route renders each package's commands: compare it
    # after the substitutions, every other answer byte for byte.
    assert port[0][:-1] == jax[0][:-1]
    (ps, pct, pallow, pbody), (js, jct, jallow, jbody) = port[0][-1], jax[0][-1]
    assert (ps, pct, pallow) == (js, jct, jallow)
    if ps == 200:
        assert json.loads(pbody) == substituted(json.loads(jbody))
    else:
        assert pbody == jbody
    assert port[1:] == jax[1:]
    statuses = [a[0] for a in port[0]]
    if auth in ("open", "token"):
        assert statuses[:3] == [201, 200, 201] and statuses[-1] == 200
        assert statuses[8] == 500 and statuses[14] == 405
    else:
        assert set(statuses) == {401}
