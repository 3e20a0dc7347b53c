"""Quantization quality of the port on a checkpoint
(``python -m dynamo_tpu_torch.tools.quant_quality CHECKPOINT``).

The counterpart of the JAX package's ``tools/quant_quality.py``: it loads
a local HF-format checkpoint with the port's loader and measures, prompt
by prompt, the last token's distribution of each quantized configuration
against the same weights' float forward:

  weight-int8      W8A8-dynamic execution of per-channel int8 weights
                   (models/quant.py) vs the dequantized float tree
  kv-int8 / kv-fp8 float weights with quantized KV pages (per-layer scales
                   calibrated on a float probe, as ``kv_scale="auto"``)
                   vs the float-page forward
  full serving     int8 weights and int8 pages vs the dequantized tree

Reported per row: mean KL divergence, top-1 agreement overall, top-1
agreement on DECISIVE positions (the reference's top-2 margin above 3x
the largest logit error: random weights give near-ties, so raw agreement
under-reports), and the smallest cosine between the two logit vectors.

The JAX tool builds its own golden checkpoint; this one takes the path of
a checkpoint directory and builds nothing.  It prints its JSON and writes
it only where ``--json`` says.  It runs on the card unless ``--device
cpu`` is given (without CUDA it raises).  ``kv_rows`` is the measuring
function on its own, for a tree already on a device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import default_device
from ..models.config import ModelConfig
from ..models.llama import PagedKVCache, RaggedBatch, forward_ragged, torch_dtype
from ..models.loader import load_params
from ..models.quant import dequantize_params, quantize_params

N_PROMPTS = 16
PROMPT_LEN = 24
PAGE = 4  # the JAX tool's page size
QMAX = {"int8": 127.0, "float8_e4m3fn": float(torch.finfo(torch.float8_e4m3fn).max)}
KV_LABELS = {"int8": "kv int8 + per-layer auto scales",
             "float8_e4m3fn": "kv fp8-e4m3 + per-layer auto scales"}


def _one_row(prompt: Sequence[int], device: torch.device):
    """A RaggedBatch of ``prompt`` alone in consecutive slots, and its
    page count (one slack page, as the JAX tool sizes it)."""
    T = len(prompt)
    nb = (T + PAGE - 1) // PAGE + 1

    def t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=device)

    rb = RaggedBatch(
        token_ids=t(list(prompt)), positions=t(list(range(T))), slot_mapping=t(list(range(T))),
        kv_lens=t([T]), page_indices=t([list(range(nb))]), cu_q_lens=t([0, T]), num_seqs=t([1]))
    return rb, nb


def forward_last(params, cfg: ModelConfig, prompt: Sequence[int], cache_dtype: str,
                 kv_scale, device: torch.device) -> np.ndarray:
    """The last token's logits [V] in f32 of one prefill of ``prompt`` into
    fresh pages of ``cache_dtype`` (quantized under ``kv_scale``)."""
    rb, nb = _one_row(prompt, device)
    cache = PagedKVCache.create(cfg, nb, PAGE, torch_dtype(cache_dtype), device)
    with torch.inference_mode():
        logits = forward_ragged(params, cfg, rb, cache, kv_scale=kv_scale)
    return logits[0].float().cpu().numpy()


def calibrate(params, cfg: ModelConfig, probe: Sequence[int], dtype_name: str,
              device: torch.device, probe_dtype: str = "float32") -> np.ndarray:
    """Per-layer KV scales from a float probe of ``probe``: each layer's
    max |K/V| over the page dtype's largest value, floored at 1e-6."""
    rb, nb = _one_row(probe, device)
    cache = PagedKVCache.create(cfg, nb, PAGE, torch_dtype(probe_dtype), device)
    with torch.inference_mode():
        forward_ragged(params, cfg, rb, cache)
        maxabs = cache.pages.float().abs().amax(dim=(1, 2, 3, 4)).cpu().numpy()
    return np.maximum(maxabs / QMAX[dtype_name], 1e-6).astype(np.float32)


def stats(ref_logits: Sequence[np.ndarray], got_logits: Sequence[np.ndarray]) -> Dict[str, Any]:
    """The JAX tool's row statistics, plus the smallest cosine."""
    kls, agree, decisive, agree_all, cosines = [], 0, 0, 0, []
    for lr, lq in zip(ref_logits, got_logits):
        pr = np.exp(lr - lr.max()); pr /= pr.sum()
        pq = np.exp(lq - lq.max()); pq /= pq.sum()
        kls.append(float(np.sum(pr * (np.log(pr + 1e-12) - np.log(pq + 1e-12)))))
        agree_all += int(np.argmax(lq) == np.argmax(lr))
        err = np.max(np.abs(lq - lr))
        top2 = np.partition(lr, -2)[-2:]
        if top2[1] - top2[0] > 3 * err:
            decisive += 1
            agree += int(np.argmax(lq) == np.argmax(lr))
        a, b = lr.astype(np.float64), lq.astype(np.float64)
        cosines.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    n = len(ref_logits)
    return {
        "mean_kl": round(float(np.mean(kls)), 6),
        "top1_agree": f"{agree_all}/{n}",
        "decisive": decisive,
        "decisive_agree": f"{agree}/{decisive}" if decisive else "0/0",
        "min_cosine": round(min(cosines), 6),
    }


def kv_rows(params, cfg: ModelConfig, prompts: List[List[int]], device: torch.device,
            names: Sequence[str] = ("int8", "float8_e4m3fn"), ref_dtype: str = "float32",
            ref: Optional[List[np.ndarray]] = None,
            ref_label: str = "bf16-KV ref") -> List[Dict[str, Any]]:
    """The kv rows: ``params`` with pages of each dtype in ``names`` under
    scales calibrated on ``prompts[0]``, against ``ref_dtype`` pages (the
    reference logits ``ref`` when given).  One row a dtype."""
    if ref is None:
        ref = [forward_last(params, cfg, p, ref_dtype, None, device) for p in prompts]
    rows = []
    for name in names:
        scales = calibrate(params, cfg, prompts[0], name, device, ref_dtype)
        got = [forward_last(params, cfg, p, name, scales, device) for p in prompts]
        rows.append({"config": f"{KV_LABELS[name]} vs {ref_label}",
                     "scales": [float(x) for x in scales], **stats(ref, got)})
    return rows


def measure(path: str, n_prompts: int = N_PROMPTS, device=None) -> Dict[str, Any]:
    """Every row of the JAX tool on the checkpoint at ``path`` (loaded in
    f32): weight-int8, kv-int8, kv-fp8 and the full serving config."""
    dev = default_device(device)
    cfg = ModelConfig.from_local_path(path).with_overrides(name="quant-quality", dtype="float32")
    params = load_params(cfg, path, dtype="float32", device=dev)
    qp = quantize_params(params)
    deq = dequantize_params(qp)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, cfg.vocab_size, size=PROMPT_LEN).tolist()
               for _ in range(n_prompts)]
    ref_deq = [forward_last(deq, cfg, p, "float32", None, dev) for p in prompts]
    ref_kv = [forward_last(params, cfg, p, "float32", None, dev) for p in prompts]
    got = [forward_last(qp, cfg, p, "float32", None, dev) for p in prompts]
    rows = [{"config": "weights int8 (W8A8-dynamic) vs dequantized ref", **stats(ref_deq, got)}]
    rows += kv_rows(params, cfg, prompts, dev, ref=ref_kv)
    int8 = calibrate(params, cfg, prompts[0], "int8", dev)
    got = [forward_last(qp, cfg, p, "int8", int8, dev) for p in prompts]
    rows.append({"config": "weights int8 + kv int8 (full serving config)", **stats(ref_deq, got)})
    return {"n_prompts": n_prompts, "prompt_len": PROMPT_LEN, "checkpoint": path,
            "device": str(dev), "rows": rows}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="a local HF-format checkpoint directory")
    ap.add_argument("--json", default=None, help="write the JSON here")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: CUDA, required)")
    args = ap.parse_args(argv)
    doc = measure(args.checkpoint, device=args.device)
    text = json.dumps(doc, indent=1)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
