"""The port's llama forward and ModelRunner against the JAX package's, with
the JAX weights carried over by params_from_jax.

- f32 twin (llama-debug-4kv-f32): logits agree to 2e-5 (the two frameworks'
  f32 matmuls sum in another order), greedy tokens are identical, and the
  pools after every commit agree to 2e-5 where written and are
  byte-identical everywhere else (the commit writes exactly the same slots).
- bf16 (llama-debug): logits agree to 0.1 -- both round activations to bf16,
  but not at the same places.
The JAX side runs its XLA attention path (attn_impl="xla"); its kernels are
held against the port's plain versions in test_torch_{decode,prefill}_attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.runner import StepInput as JaxStepInput
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.attention import write_kv_pages_all_layers as jax_commit
from production_stack_tpu_torch.engine.model_loader import load_model, params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers

F32 = dict(atol=2e-5, rtol=2e-5)
PAGE, NUM_PAGES = 8, 24


def _jax_params(name):
    cfg = dataclasses.replace(jllama.PRESETS[name], attn_impl="xla")
    return cfg, jax.device_get(jllama.init_params(cfg, jax.random.key(0)))


def _port_model(name, np_params):
    _, cfg, model = load_model(name, device="cpu", params=params_from_jax(np_params, tllama.PRESETS[name]))
    return cfg, model


def test_params_from_jax_keeps_every_bit():
    _, p = _jax_params("llama-debug")
    assert p["embed"].dtype == ml_dtypes.bfloat16
    cfg, model = _port_model("llama-debug", p)
    sd = dict(model.named_parameters())
    assert torch.equal(sd["embed"].view(torch.int16), torch.from_numpy(p["embed"].view(np.int16)))
    for name, stacked in p["layers"].items():
        for i in range(cfg.num_layers):
            got = sd[f"layers.{i}.{name}"]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), torch.from_numpy(np.ascontiguousarray(stacked[i]).view(np.int16)))
    assert not cfg.tie_word_embeddings
    assert torch.equal(sd["lm_head"].view(torch.int16), torch.from_numpy(p["lm_head"].view(np.int16)))


def _pools(cfg_j, seed=3):
    rng = np.random.RandomState(seed)
    shape = (cfg_j.num_layers, NUM_PAGES, PAGE, cfg_j.num_kv_heads, cfg_j.head_dim)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _chunks():
    """Two prefill chunks of a 2-row batch (row 1 ragged, padded), as
    (input_ids, positions, kv_lens); then the burst's start state."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 512, (2, 40)).astype(np.int32)
    out = []
    for start, n in (((0, 0), (16, 11)), ((16, 11), (16, 13))):
        pos = np.full((2, 16), -1, np.int32)
        inp = np.zeros((2, 16), np.int32)
        for b in range(2):
            pos[b, : n[b]] = np.arange(start[b], start[b] + n[b])
            inp[b, : n[b]] = ids[b, start[b]: start[b] + n[b]]
        out.append((inp, pos, np.array([start[0] + n[0], start[1] + n[1]], np.int32)))
    return ids, out


PT = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)


@pytest.mark.parametrize("name,dtype,tol", [
    ("llama-debug-4kv-f32", np.float32, F32),
    ("llama-debug", ml_dtypes.bfloat16, dict(atol=0.1, rtol=0.0)),
])
def test_forward_prefill_chunks_and_burst_match_jax(name, dtype, tol):
    cfg_j, p = _jax_params(name)
    cfg_t, model = _port_model(name, p)
    k0, v0 = (x.astype(dtype) for x in _pools(cfg_j))
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk = torch.from_numpy(k0.view(np.int16) if dtype != np.float32 else k0.copy())
    tv = torch.from_numpy(v0.view(np.int16) if dtype != np.float32 else v0.copy())
    if dtype != np.float32:
        tk, tv = tk.view(torch.bfloat16), tv.view(torch.bfloat16)
    ids, chunks = _chunks()
    with torch.no_grad():
        for inp, pos, lens in chunks:
            jl, jk, jv = jllama.forward(p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jk, jv, jnp.asarray(PT), jnp.asarray(lens))
            tl = model(torch.from_numpy(inp), torch.from_numpy(pos), tk, tv, torch.from_numpy(PT), torch.from_numpy(lens))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        # a 3-step deferred burst: pools read-only, windows grow, one commit
        L, KH, D = cfg_j.num_layers, cfg_j.num_kv_heads, cfg_j.head_dim
        C = 3
        jka = jnp.zeros((L, 2, C, KH, D), jk.dtype)
        jva = jnp.zeros_like(jka)
        tka = torch.zeros((L, 2, C, KH, D), dtype=tk.dtype)
        tva = torch.zeros_like(tka)
        lens0 = chunks[-1][2]
        for s in range(C):
            inp = np.stack([ids[0, 32 + s], ids[1, 24 + s]])[:, None].astype(np.int32)
            pos = (lens0 + s)[:, None].astype(np.int32)
            lens = (lens0 + s + 1).astype(np.int32)
            cnt = np.full((2,), s, np.int32)
            jl, jka, jva = jllama.forward(
                p, cfg_j, jnp.asarray(inp), jnp.asarray(pos), jk, jv, jnp.asarray(PT), jnp.asarray(lens),
                kv_burst=(jka, jva, jnp.asarray(cnt)),
            )
            tl = model(
                torch.from_numpy(inp), torch.from_numpy(pos), tk, tv, torch.from_numpy(PT), torch.from_numpy(lens),
                kv_burst=(tka, tva, torch.from_numpy(cnt)),
            )
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    commit = (lens0[:, None] + np.arange(C)[None]).astype(np.int32)
    jk, jv = jax_commit(jk, jv, jka, jva, jnp.asarray(PT), jnp.asarray(commit))
    write_kv_pages_all_layers(tk, tv, tka, tva, torch.from_numpy(PT), torch.from_numpy(commit))
    if dtype == np.float32:
        for t, j, init in ((tk, jk, k0), (tv, jv, v0)):
            t, j = t.numpy(), np.asarray(j)
            written = np.any(j != init, axis=(-2, -1))
            np.testing.assert_array_equal(np.any(t != init, axis=(-2, -1)), written)
            np.testing.assert_allclose(t, j, **F32)
            assert t[~written].tobytes() == j[~written].tobytes()  # untouched slots keep every bit


def _step(ids, pos, lens, pt, limits=None, cls=StepInput):
    B = ids.shape[0]
    return cls(
        input_ids=ids, positions=pos, page_table=pt, kv_lens=lens,
        temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
        kv_limits=limits,
    )


def test_runner_greedy_tokens_over_prefill_and_two_bursts_match_jax():
    name = "llama-debug-4kv-f32"
    cfg_j, p = _jax_params(name)
    _, model = _port_model(name, p)
    jr = JaxRunner(cfg_j, params=jax.tree.map(jnp.asarray, p), num_pages=NUM_PAGES, page_size=PAGE, seed=0)
    tr = ModelRunner(model, num_pages=NUM_PAGES, page_size=PAGE, seed=0, device="cpu")
    _, chunks = _chunks()
    got = {}
    for tag, runner, cls in (("jax", jr, JaxStepInput), ("port", tr, StepInput)):
        toks = []
        for inp, pos, lens in chunks:
            ids, _ = runner.step(_step(inp, pos, lens, PT, cls=cls))
        nxt = np.asarray(ids if tag == "jax" else ids.numpy())
        toks.append(nxt)
        lens = chunks[-1][2].copy()
        limits = np.array([37, 30], np.int32)  # row 1 stops mid-burst 2
        for _ in range(2):
            out = runner.step_multi(
                _step(nxt[:, None].astype(np.int32), lens[:, None].astype(np.int32), lens + 1, PT, limits, cls),
                4,
            )
            out = np.asarray(out if tag == "jax" else out.numpy())
            toks.append(out)
            nxt = out[:, -1]
            lens = lens + 4
        got[tag] = (np.concatenate([t.reshape(2, -1) for t in toks], 1), runner)
    # the tokens the host keeps: a burst starting at kv_len L0 yields
    # min(k, kv_limits - L0 + 1) real tokens; a stopped row's later draws
    # are discarded (and differ by design between attention paths)
    keep = [np.ones(2, int)]
    for l0 in (chunks[-1][2] + 1, chunks[-1][2] + 5):
        n = np.minimum(4, np.array([37, 30]) - l0 + 1)
        keep.append(np.arange(4)[None] < n[:, None])
    keep = np.concatenate([k.reshape(2, -1) for k in keep], 1).astype(bool)
    assert keep.sum() == 1 * 2 + 4 * 2 + 1 + 2
    np.testing.assert_array_equal(got["port"][0][keep], got["jax"][0][keep])
    # pages written by the prefill and both bursts agree, in the JAX layout
    jks, _ = jr.get_pages([0, 1, 5, 6])
    tks, _ = tr.get_pages([0, 1, 5, 6])
    assert [x.shape for x in tks] == [x.shape for x in jks] and tks[0].dtype == jks[0].dtype
    np.testing.assert_allclose(np.stack(tks), np.stack(jks), **F32)


def test_runner_pages_round_trip_in_the_jax_layout():
    _, cfg, model = load_model("llama-debug", device="cpu")
    tr = ModelRunner(model, num_pages=8, page_size=PAGE, device="cpu")
    rng = np.random.RandomState(5)
    shape = (cfg.num_layers, PAGE, cfg.num_kv_heads, cfg.head_dim)
    ks = [rng.randn(*shape).astype(ml_dtypes.bfloat16) for _ in range(2)]
    vs = [rng.randn(*shape).astype(ml_dtypes.bfloat16) for _ in range(2)]
    tr.set_pages([6, 2], ks, vs)
    gk, gv = tr.get_pages([6, 2])
    for a, b in zip(gk + gv, ks + vs):
        assert a.dtype == ml_dtypes.bfloat16 and a.shape == shape
        assert a.tobytes() == b.tobytes()
    tr.reset_kv()
    assert not tr.k_pages.any() and not tr.v_pages.any()


@pytest.mark.parametrize("name", sorted(tllama.PRESETS))
def test_presets_equal_the_jax_presets(name):
    """Every preset the port declares is the JAX preset of the same name,
    field by field (dtypes mapped; attn_impl names differ by design)."""
    port, ref = tllama.PRESETS[name], jllama.PRESETS[name]
    shared = {f.name for f in dataclasses.fields(port)} - {"attn_impl", "dtype", "rope_scaling"}
    assert {k: getattr(port, k) for k in shared} == {k: getattr(ref, k) for k in shared}
    assert str(port.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
    assert (port.rope_scaling is None) == (ref.rope_scaling is None)
    if ref.rope_scaling is not None:
        assert dataclasses.asdict(port.rope_scaling) == dataclasses.asdict(ref.rope_scaling)
