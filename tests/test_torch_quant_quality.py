"""The port's quantization-quality tool
(``dynamo_tpu_torch/tools/quant_quality.py``) against the JAX package's
``tools/quant_quality.py`` on the JAX tool's golden checkpoint
(``tests/test_real_checkpoint.py``'s builder) at 4 prompts: every row —
weight-int8, kv-int8, kv-fp8, the full serving config — with its mean KL
within 1e-5 of JAX's and its top-1 counts equal."""

import json
import os
import sys

import numpy as np
import pytest

from dynamo_tpu_torch.tools import quant_quality

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from test_real_checkpoint import build_checkpoint

    path = str(tmp_path_factory.mktemp("golden") / "model")
    build_checkpoint(path)
    return path


def _jax_rows(path):
    """The JAX tool's four rows at N prompts (its own functions, its prompt
    draw)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import quant_quality as jq
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    from dynamo_tpu.models.config import ModelConfig
    from dynamo_tpu.models.loader import load_params
    from dynamo_tpu.models.quant import dequantize_params, quantize_params

    cfg = ModelConfig.from_local_path(path).with_overrides(name="golden-tiny", dtype="float32")
    params = load_params(cfg, path)
    qp = quantize_params(load_params(cfg, path))
    deq = dequantize_params(qp)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, cfg.vocab_size, size=jq.PROMPT_LEN).tolist() for _ in range(N)]
    scales = {n: jq._calibrate(params, cfg, prompts[0], n) for n in ("int8", "float8_e4m3fn")}
    ref_deq = [jq._forward(deq, cfg, p, "float32", None) for p in prompts]
    ref_kv = [jq._forward(params, cfg, p, "float32", None) for p in prompts]
    rows = [jq._stats(ref_deq, [jq._forward(qp, cfg, p, "float32", None) for p in prompts])]
    for name in ("int8", "float8_e4m3fn"):
        rows.append(jq._stats(ref_kv, [jq._forward(params, cfg, p, name, scales[name])
                                       for p in prompts]))
    rows.append(jq._stats(ref_deq, [jq._forward(qp, cfg, p, "int8", scales["int8"])
                                    for p in prompts]))
    return rows, scales


def test_rows_equal_the_jax_tool(checkpoint):
    want, scales = _jax_rows(checkpoint)
    got = quant_quality.measure(checkpoint, N, "cpu")
    assert got["n_prompts"] == N and got["prompt_len"] == 24
    assert [r["config"] for r in got["rows"]] == [
        "weights int8 (W8A8-dynamic) vs dequantized ref",
        "kv int8 + per-layer auto scales vs bf16-KV ref",
        "kv fp8-e4m3 + per-layer auto scales vs bf16-KV ref",
        "weights int8 + kv int8 (full serving config)",
    ]
    for g, w in zip(got["rows"], want):
        assert abs(g["mean_kl"] - w["mean_kl"]) <= 1e-5, (g, w)
        for key in ("top1_agree", "decisive", "decisive_agree"):
            assert g[key] == w[key], (key, g, w)
        assert 0.99 < g["min_cosine"] <= 1.0 + 1e-9
    # the kv rows' calibrated scales are the JAX tool's
    for row, name in zip(got["rows"][1:3], ("int8", "float8_e4m3fn")):
        np.testing.assert_allclose(row["scales"], np.asarray(scales[name]), rtol=1e-5)


def test_json_only_where_asked(checkpoint, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert quant_quality.main([checkpoint, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["n_prompts"] == quant_quality.N_PROMPTS
    assert os.listdir(tmp_path) == []
    out = tmp_path / "qq.json"
    assert quant_quality.main([checkpoint, "--device", "cpu", "--json", str(out)]) == 0
    assert len(json.loads(out.read_text())["rows"]) == 4


def test_without_cuda_raises(checkpoint):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quant_quality.main([checkpoint])


def test_kv_rows_on_a_tree_in_memory():
    """The measuring function phase b calls on the card: a tree already on
    a device, pages of each dtype against float pages."""
    import torch

    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.llama import init_params

    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    params = init_params(cfg, seed=3, device=torch.device("cpu"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=20).tolist() for _ in range(3)]
    rows = quant_quality.kv_rows(params, cfg, prompts, torch.device("cpu"),
                                 names=("float8_e4m3fn",), ref_label="f32 pages")
    (row,) = rows
    assert row["config"] == "kv fp8-e4m3 + per-layer auto scales vs f32 pages"
    assert len(row["scales"]) == cfg.num_layers
    assert row["top1_agree"].endswith("/3") and row["min_cosine"] > 0.99
