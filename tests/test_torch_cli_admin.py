"""The port's CLI commands beyond serving, against the JAX package's
(``dynamo_tpu/cli.py``):

- the repaired ``run`` QoS flags: ``run in=http out=torch --qos-rate 5
  --qos-burst 10 --brownout`` parses on both packages and the colocated
  edge gets the same ``QosController`` config (the port's ``run`` had none
  of the three flags, and its edge ignored them);
- ``model add|list|remove``: the same hub entries as the JAX command (an
  ``hf`` tokenizer spec registered as given), the same listing, removal of
  every registration, the parser's checks;
- ``deploy render|preview`` on a CR file: the JAX output after the
  renderer's substitutions; the repository's v5e example refused for its
  TPU topology; without PyYAML a refusal naming it;
- ``prepare``: a local directory, a ``.gguf`` file and a pre-staged cache
  entry print the JAX command's paths; a remote repo id is refused with
  the port's no-download message;
- ``operator``: both reconcilers over the port's ``KubeApi`` against the
  JAX tests' fake API server, as the JAX command drives them;
- ``api-store``: the JAX command's announce line and bodies, the
  non-loopback warning and the ``DYN_API_TOKEN`` gate.
"""

import argparse
import asyncio
import copy
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import yaml

from test_kube_api import MockApiServer, _sa_dir  # the JAX tests' fake API server

pytestmark = pytest.mark.torch_port

JAX, PORT = "dynamo_tpu", "dynamo_tpu_torch"
PKGS = (PORT, JAX)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli(pkg):
    return importlib.import_module(f"{pkg}.cli")


def _env(**extra):
    from conftest import hermetic_child_env

    return {**hermetic_child_env(REPO), **extra}


def _run_cli(pkg, *argv, env=None, timeout=120):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", *argv], cwd=REPO,
                          env=env or _env(), capture_output=True, text=True, timeout=timeout)


def _qos_config(ctl):
    cfg = vars(ctl.config).copy()
    if cfg.get("brownout") is not None:
        cfg["brownout"] = vars(cfg["brownout"])
    return cfg


QOS_ARGV = ["run", "in=http", "out=torch", "--qos-rate", "5", "--qos-burst", "10", "--brownout"]


def test_run_qos_flags_reach_the_colocated_edge(monkeypatch):
    """The port's ``run`` parses the JAX ``run``'s QoS flags and its
    colocated edge gets the QosController the JAX ``_edge_qos`` builds from
    the same line."""
    seen = {}

    async def capture(args, *_, **__):
        seen["jax"] = args

    monkeypatch.setattr(cli(JAX), "_run", capture)
    cli(JAX).main(QOS_ARGV)
    want = _qos_config(cli(JAX)._edge_qos(seen["jax"]))

    args = cli(PORT).parse_args(QOS_ARGV)
    assert (args.qos_rate, args.qos_burst, args.brownout) == (5.0, 10.0, True)
    args.out, args.port, args.host, args.model = "echocore", 0, "127.0.0.1", "m"

    async def serve():
        got = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(cli(PORT)._run(args, on_serving=got.set_result))
        try:
            service = await asyncio.wait_for(got, 30)
            return None if service.qos is None else _qos_config(service.qos)
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    got = asyncio.run(serve())
    assert got == want
    assert want["rate"] == 5.0 and want["burst"] == 10.0 and want["brownout"] is not None


def test_run_without_qos_flags_keeps_the_edge_plain():
    args = cli(PORT).parse_args(["run", "in=http", "out=echocore"])
    assert (args.qos_rate, args.qos_burst, args.brownout) == (None, None, False)
    assert cli(PORT)._edge_qos(args) is None


# ------------------------------------------------------------------- model


def _hub_dump(address):
    from dynamo_tpu_torch.runtime.transports.hub import HubClient

    async def go():
        c = await HubClient(address).connect()
        try:
            return await c.kv_get_prefix("models/")
        finally:
            await c.close()

    return asyncio.run(go())


@pytest.fixture
def hub_address():
    from dynamo_tpu_torch.runtime.transports.hub import HubServer

    loop = asyncio.new_event_loop()
    server = loop.run_until_complete(HubServer(host="127.0.0.1", port=0).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        yield server.address
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


def test_model_registry_matches_jax(hub_address):
    names = {PORT: "m-port", JAX: "m-jax"}
    entries, outputs = {}, {}
    for pkg in PKGS:
        name = names[pkg]
        outs = [
            _run_cli(pkg, "model", "add", name, "ns.Comp.generate", "--hub", hub_address),
            _run_cli(pkg, "model", "add", f"{name}-hf", "ns.Comp.generate", "--hub", hub_address,
                     "--type", "chat", "--tokenizer", "tok.json", "--block-size", "32"),
        ]
        assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
        outputs[pkg] = [re.sub(r"\(models/.*\)", "(KEY)", o.stdout.replace(name, "NAME"))
                        for o in outs]
        entries[pkg] = sorted((re.sub(r"/\d+$", "/WID", k.replace(name, "NAME")),
                               {**v, "name": v["name"].replace(name, "NAME")})
                              for k, v in _hub_dump(hub_address).items()
                              if k.startswith(f"models/{name}"))
    assert entries[PORT] == entries[JAX]
    assert outputs[PORT] == outputs[JAX]
    assert dict(entries[PORT])["models/NAME-hf/WID"]["tokenizer"] == {"kind": "hf",
                                                                     "file": "tok.json"}
    lists = {pkg: _run_cli(pkg, "model", "list", "--hub", hub_address).stdout for pkg in PKGS}
    assert lists[PORT] == lists[JAX]
    assert len(lists[PORT].splitlines()) == 4
    removed = {pkg: _run_cli(pkg, "model", "remove", names[pkg], "--hub", hub_address).stdout
               for pkg in PKGS}
    assert removed[PORT].replace("m-port", "NAME") == removed[JAX].replace("m-jax", "NAME")
    assert "removed 1 registration(s)" in removed[PORT]
    left = sorted(k.rsplit("/", 1)[0] for k in _hub_dump(hub_address))
    assert left == ["models/m-jax-hf", "models/m-port-hf"]


@pytest.mark.parametrize("argv", [["model", "add", "x", "--hub", "h:1"],
                                  ["model", "remove", "--hub", "h:1"],
                                  ["model", "add", "--hub", "h:1"]])
def test_model_parser_checks_match_jax(argv):
    got = {pkg: _run_cli(pkg, *argv) for pkg in PKGS}
    assert got[PORT].returncode == got[JAX].returncode == 2
    assert got[PORT].stderr.splitlines()[-1].split(": error: ")[1] == \
        got[JAX].stderr.splitlines()[-1].split(": error: ")[1]


# ------------------------------------------------------------------ deploy


def _one_card_cr():
    with open(os.path.join(REPO, "deploy", "k8s", "example-deployment.yaml")) as f:
        cr = yaml.safe_load(f)
    dec = cr["spec"]["services"]["decode"]
    dec.pop("nnodes")
    dec["tpu"] = {"accelerator": "nvidia-h100-80gb-hbm3", "chips": 1}
    dec["engine"] = {"max-batch": 64}
    pre = cr["spec"]["services"]["prefill"]
    pre["tpu"] = {"accelerator": "nvidia-h100-80gb-hbm3", "chips": 1}
    pre["engine"] = {"tp": 1}
    return cr


def _substituted_text(text):
    return (text.replace("dynamo_tpu.cli", "dynamo_tpu_torch.cli").replace("out=tpu", "out=torch")
            .replace("cloud.google.com/gke-tpu-accelerator", "nvidia.com/gpu.product")
            .replace("google.com/tpu", "nvidia.com/gpu"))


@pytest.mark.parametrize("verb", ["render", "preview"])
def test_deploy_command_matches_jax(tmp_path, verb):
    path = tmp_path / "cr.yaml"
    path.write_text(yaml.safe_dump(_one_card_cr()))
    got = {pkg: _run_cli(pkg, "deploy", verb, "-f", str(path)) for pkg in PKGS}
    assert got[PORT].returncode == got[JAX].returncode == 0, got[PORT].stderr
    assert got[PORT].stdout == _substituted_text(got[JAX].stdout)
    assert "nvidia.com/gpu" in got[PORT].stdout or verb == "preview"


def test_deploy_refuses_the_v5e_example_and_names_pyyaml(monkeypatch, capsys):
    example = os.path.join(REPO, "deploy", "k8s", "example-deployment.yaml")
    r = _run_cli(PORT, "deploy", "render", "-f", example)
    assert r.returncode == 1 and r.stdout == ""
    assert "tpu.topology names a TPU slice" in r.stderr
    assert _run_cli(JAX, "deploy", "preview", "-f", example).returncode == 0
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML"):
        cli(PORT).main(["deploy", "preview", "-f", example])


# ----------------------------------------------------------------- prepare


def test_prepare_resolves_local_specs_like_jax(tmp_path):
    ckpt = tmp_path / "m"
    ckpt.mkdir()
    (ckpt / "config.json").write_text("{}")
    gguf = tmp_path / "w.gguf"
    gguf.write_bytes(b"GGUF")
    cache = tmp_path / "cache"
    staged = cache / "org--name"
    staged.mkdir(parents=True)
    (staged / "config.json").write_text("{}")
    alias = cache / "deepseek-ai--DeepSeek-R1-Distill-Llama-8B"
    alias.mkdir()
    (alias / "config.json").write_text("{}")
    cases = [[str(ckpt)], [str(gguf)], ["org/name", "--cache", str(cache)],
             ["deepseek-r1-distill-llama-8b", "--cache", str(cache), "--revision", "main"]]
    for argv in cases:
        got = {pkg: _run_cli(pkg, "prepare", *argv, env=_env(HF_HUB_OFFLINE="1"))
               for pkg in PKGS}
        assert got[PORT].returncode == got[JAX].returncode == 0, got[PORT].stderr
        assert got[PORT].stdout == got[JAX].stdout
    assert got[PORT].stdout.strip() == str(alias)


def test_prepare_refuses_a_remote_repo_id(tmp_path):
    """Nothing is downloaded: the port names the directory to pre-stage."""
    r = _run_cli(PORT, "prepare", "org/absent", "--cache", str(tmp_path))
    assert r.returncode == 1 and r.stdout == ""
    assert "does not download (no huggingface_hub)" in r.stderr
    assert str(tmp_path / "org--absent") in r.stderr


# ---------------------------------------------------------------- operator


def _operator_run(pkg, tmp_path, monkeypatch):
    """The ``operator`` command's loop in this process, over ``pkg``'s
    KubeApi against the fake API server: a deployment CR and a model-cache
    CR arrive on the watch; the server's objects once both are reconciled."""
    C = importlib.import_module(f"{pkg}.deploy.controller")
    monkeypatch.setattr(C.KubeApi, "SA", _sa_dir(tmp_path, "tok-1"))

    async def main():
        server = await MockApiServer().start()
        args = argparse.Namespace(
            namespace="ns1", poll_interval=60.0, api_server=f"http://127.0.0.1:{server.port}")
        task = asyncio.create_task(cli(pkg)._run_operator(args))
        try:
            for _ in range(200):
                if server.watch_streams >= 2:
                    break
                await asyncio.sleep(0.05)
            assert server.watch_streams >= 2  # both reconcilers watch
            cr = {"apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuDeployment",
                  "metadata": {"name": "app"},
                  "spec": {"image": "img:1", "services": {"hub": {"role": "hub"},
                                                          "w": {"role": "worker"}}}}
            mc = {"apiVersion": "dynamo.tpu.io/v1alpha1", "kind": "DynamoTpuModelCache",
                  "metadata": {"name": "r1"},
                  "spec": {"model": "org/m", "image": "img:1", "pvc": "cache"}}
            server.objects[("dynamotpudeployments", "app")] = cr
            server.objects[("dynamotpumodelcaches", "r1")] = mc
            # The fake server's streams share one event queue: an event
            # each for both streams, whichever takes which.
            for obj in (cr, mc, cr, mc):
                await server.watch_events.put({"type": "ADDED", "object": obj})
                await asyncio.sleep(0.05)
            for _ in range(600):  # both reconciled: each CR's status written last
                if all("status" in server.objects[key] for key in (
                        ("dynamotpudeployments", "app"), ("dynamotpumodelcaches", "r1"))):
                    break
                await asyncio.sleep(0.05)
            return {f"{pl}/{n}": copy.deepcopy(m) for (pl, n), m in sorted(server.objects.items())}
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            for _ in range(3):  # let each watch handler see its closed socket
                await server.watch_events.put({"type": "BOOKMARK"})
                await asyncio.sleep(0.05)
            await server.close()

    return asyncio.run(main())


def test_operator_reconciles_both_crds_like_jax(tmp_path, monkeypatch):
    got = {pkg: _operator_run(pkg, tmp_path, monkeypatch) for pkg in PKGS}
    want = json.loads(_substituted_text(json.dumps(got[JAX])).replace(
        '{"name": "JAX_PLATFORMS", "value": "cpu"}', '{"name": "CUDA_VISIBLE_DEVICES", "value": ""}'))
    assert got[PORT] == want
    assert got[PORT]["dynamotpudeployments/app"]["status"]["totalServices"] == 2
    assert got[PORT]["dynamotpumodelcaches/r1"]["status"] == {"phase": "Pending"}


# --------------------------------------------------------------- api-store


class _Store:
    def __init__(self, pkg, hub, *extra, env=None):
        self.p = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli", "api-store", "--hub", hub, "--port", "0", *extra],
            cwd=REPO, env=env or _env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines = []
        self.reader = threading.Thread(target=lambda: self.lines.extend(self.p.stdout))
        self.reader.start()
        end = time.time() + 60
        while not any(ln.startswith("api-store on ") for ln in self.lines):
            assert self.p.poll() is None and time.time() < end, self.lines
            time.sleep(0.05)
        line = next(ln for ln in self.lines if ln.startswith("api-store on "))
        self.base = line.split()[-1].replace("0.0.0.0", "127.0.0.1")

    def call(self, method, path, body=None, token=None):
        req = urllib.request.Request(self.base + path, method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Authorization": f"Bearer {token}"} if token else {})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def stop(self):
        self.p.terminate()
        rc = self.p.wait(30)
        self.reader.join(10)
        return rc


def test_api_store_command_matches_jax(hub_address):
    spec = {"name": "d1", "image": "img:1", "services": {"hub": {"role": "hub"}}}
    answers, lines = {}, {}
    for pkg in PKGS:
        store = _Store(pkg, hub_address)
        try:
            answers[pkg] = [store.call("POST", "/api/v1/deployments", spec),
                            store.call("GET", "/api/v1/deployments/d1"),
                            store.call("DELETE", "/api/v1/deployments/d1"),
                            store.call("GET", "/api/v1/deployments/d1")]
        finally:
            assert store.stop() == 0
        lines[pkg] = [re.sub(r":\d+$", ":P", ln.rstrip("\n")) for ln in store.lines
                      if ln.startswith("api-store")]
    assert answers[PORT] == answers[JAX]
    assert [s for s, _ in answers[PORT]] == [201, 200, 200, 404]
    assert lines[PORT] == lines[JAX] == ["api-store on http://127.0.0.1:P"]


def test_api_store_warns_off_loopback_and_takes_the_env_token(hub_address):
    out = {}
    for pkg in PKGS:
        store = _Store(pkg, hub_address, "--host", "0.0.0.0")
        try:
            out[pkg] = [ln for ln in store.lines if "WARNING" in ln]
        finally:
            store.stop()
    assert out[PORT] == out[JAX] and len(out[PORT]) == 1
    store = _Store(PORT, hub_address, "--host", "0.0.0.0", env=_env(DYN_API_TOKEN="s3"))
    try:
        assert not [ln for ln in store.lines if "WARNING" in ln]
        assert store.call("GET", "/api/v1/deployments")[0] == 401
        assert store.call("GET", "/api/v1/deployments", token="s3") == (200, b'{"items": []}')
    finally:
        store.stop()
