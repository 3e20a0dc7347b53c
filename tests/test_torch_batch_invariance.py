"""The engine's ``batch_invariant`` mode: ``forward_ragged``'s ``pad_rows``
and the scheduler's whole prompt pieces (the cut is held in
test_torch_pipeline.py).

A token's logits and K/V must be the same bits whatever else its step
carries: the chaos ladder compares its rungs' streams with L0's bit for
bit.  The CPU cases run debug-tiny in f32; the card case runs llama-3.1-8b
widths at two layers in bf16, where cuBLAS picks another kernel for 16 rows
than for 4 or 32, and skips without CUDA.  The file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest tests/test_torch_batch_invariance.py -q
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import get_config

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
S, PP = 4, 5  # rows and pages per row of every step


def _batch(rows, T, ps):
    """rows: [(all_tokens, start, n, table)] → RaggedBatch fields (numpy);
    rows past ``rows`` are padding rows attending over one position."""
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.full(T, -1, np.int32)
    kv = np.ones(S, np.int32)
    tables = np.zeros((S, PP), np.int32)
    cu = np.zeros(S + 1, np.int32)
    at = 0
    for i, (toks, start, n, table) in enumerate(rows):
        p = np.arange(start, start + n)
        tok[at:at + n] = toks[start:start + n]
        pos[at:at + n] = p
        slots[at:at + n] = np.asarray(table)[p // ps] * ps + p % ps
        tables[i] = table
        kv[i] = start + n
        at += n
        cu[i + 1] = at
    cu[len(rows) + 1:] = at
    return dict(token_ids=tok, positions=pos, slot_mapping=slots, kv_lens=kv,
                page_indices=tables, cu_q_lens=cu,
                num_seqs=np.asarray([len(rows)], np.int32))


def _decode(rows, ps):
    """One decode token after each row's prompt, as a ``decode=True`` step."""
    fields = _batch([(t, n, 1, tb) for t, _, n, tb in rows], S, ps)
    fields["cu_q_lens"] = np.arange(S + 1, dtype=np.int32)
    return fields


def _rb(fields, dev):
    return tl.RaggedBatch(**{k: torch.from_numpy(v).to(dev) for k, v in fields.items()})


def _prompts(n):
    rng = np.random.default_rng(1)
    toks = [rng.integers(1, 256, size=20).tolist() for _ in range(n)]
    tables = [np.arange(i * PP, (i + 1) * PP, dtype=np.int32) for i in range(n)]
    return toks, tables


def test_pad_rows_keeps_the_forward():
    """``pad_rows`` changes only the row count the per-token layers run at:
    a prefill step's and a decode step's logits and pages stay the
    unpadded forward's, at 1e-5 (f32 summation order)."""
    cfg = get_config("debug-tiny").with_overrides(dtype="float32")
    params = tl.init_params(cfg, seed=0, device=CPU)
    toks, tables = _prompts(3)
    rows = [(toks[0], 0, 9, tables[0]), (toks[1], 0, 6, tables[1]), (toks[2], 0, 5, tables[2])]
    caches = [tl.PagedKVCache.create(cfg, 3 * PP, 4, torch.float32, CPU) for _ in range(2)]
    for fields, decode in ((_batch(rows, 32, 4), False), (_decode(rows, 4), True)):
        with torch.inference_mode():
            # 12 rows a call: slabs, the last one padded, in both steps
            ref, got = (tl.forward_ragged(params, cfg, _rb(fields, CPU), c, decode=decode,
                                          pad_rows=pad)
                        for c, pad in zip(caches, (0, 12)))
        np.testing.assert_allclose(got[:3].numpy(), ref[:3].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(caches[1].pages.numpy(), caches[0].pages.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_pad_rows_make_a_row_batch_invariant(device):
    """With ``pad_rows`` a prompt's last logits and K/V, and its next
    decode token's logits, are the same bits alone in a 16-token step and
    packed behind two other prompts in a 32-token one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuBLAS's choice by row count is the card's")
    dev = torch.device(device)
    if dev.type == "cuda":
        cfg, ps = get_config("llama-3.1-8b").with_overrides(num_layers=2), 16
    else:
        cfg, ps = get_config("debug-tiny").with_overrides(dtype="float32"), 4
    params = tl.init_params(cfg, seed=0, device=dev)
    toks, tables = _prompts(3)
    a = (toks[0], 0, 11, tables[0])
    runs = []
    for rows, T in (([a], 16), ([(toks[1], 0, 9, tables[1]), (toks[2], 0, 7, tables[2]), a], 32)):
        cache = tl.PagedKVCache.create(cfg, 3 * PP, ps, tl.torch_dtype(cfg.dtype), dev)
        out = []
        for fields, decode in ((_batch(rows, T, ps), False), (_decode(rows, ps), True)):
            with torch.inference_mode():
                logits = tl.forward_ragged(params, cfg, _rb(fields, dev), cache, decode=decode,
                                           pad_rows=64)
            out.append(logits[len(rows) - 1].float().cpu())
        runs.append((out, cache.pages[:, torch.from_numpy(tables[0][:3]).to(dev)].float().cpu()))
    (alone, pages_alone), (packed, pages_packed) = runs
    for x, y in zip(alone, packed):
        assert torch.equal(x, y)
    assert torch.equal(pages_alone, pages_packed)
