"""The encoder-decoder family against the reference on the CPU: reduced
whisper-medium (2 + 2 layers, 64 frames drawn from a seeded normal)
served whole under ``ff_reduce`` (``test_torch_families.check_serving``;
tolerances there): the encoder's non-causal attention, the cross K/V
filled once from its output, cross attention in the prefill (non-causal
``ff.attention``) and in each decode step (``decode_attention`` over the
whole encoder length).  ``ff_math`` in this family is the MLP's silu
gate, held to the reference in tests/test_torch_train.py and
test_torch_moe.py, so its case is left out (each case costs the
reference four traces and compiles).
"""

import numpy as np
import torch

import repro_torch.ff as port_ff
import test_torch_families as families
from repro_torch.models import model as port_model

one_thread = families.one_thread


def test_prefill_and_decode_logits_match_reference():
    families.check_serving("whisper-medium", "ff_reduce", "logits")


def test_greedy_generate_matches_reference():
    families.check_serving("whisper-medium", "ff_reduce", "tokens")


def test_cross_cache_takes_the_encoder_length():
    """Frames of another length than ``encoder_seq`` fill a cross cache of
    their own length (the reference's prefill replaces the cache's cross
    K/V with its encoder output's), and the decode step reads it whole."""
    _, pcfg = families.serve_configs("whisper-medium",
                                     compute_dtype="float32")
    w = port_model.init_params(pcfg, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    frames = torch.randn((2, 40, pcfg.d_model), generator=g)
    toks = torch.randint(0, pcfg.vocab_size, (2, 5), generator=g)
    cache = port_model.init_cache(pcfg, 2, 8, torch.float32, device="cpu")
    assert cache["cross"]["k"].shape[2] == pcfg.encoder_seq
    with port_ff.policy("ff_reduce", attention="ff"):
        logits, cache = port_model.prefill(
            w, {"tokens": toks, "frames": frames}, pcfg, cache)
        assert cache["cross"]["k"].shape == (
            pcfg.num_layers, 2, 40, pcfg.num_kv_heads,
            pcfg.resolved_head_dim)
        step, _ = port_model.decode_step(w, logits.argmax(-1)[:, None], 5,
                                         cache, pcfg)
    assert np.isfinite(step.numpy()).all()
