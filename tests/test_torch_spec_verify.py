"""The verify forward of speculative decoding at sequence and pipeline ranks
in the port: step_spec's 1 + k = 5 chunk after ragged histories, one row
inactive (positions -1, as step_spec feeds a row that stopped), with
``all_logits``, through gloo rank processes of the port's model at sp 2
(the chunk padded to 6 tokens, 3 a rank, through the ring; every
position's hidden state gathered before the head), pp 2 (the stages'
microbatches through the prefill kernel's plain version) and pp 2 x sp 2,
against the JAX ``llama.forward(all_logits=True)`` on the same mesh and
pools: every position's logits and the written slots within 2e-5, every
other slot byte for byte as it was, the sequence ranks' pools the same
bytes.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.testing.procs import free_port
from test_torch_sp import F32, MODEL, ROOT, SMALL, _pools, _written_slots

K = 4
VERIFY_MESHES = {"sp2": (1, 2), "pp2": (2, 1), "pp2sp2": (2, 2)}  # (pp, sp)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX engine's weights of the f32 twin (one device)."""
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, **SMALL))
    try:
        return jax.device_get(jeng.runner.params)
    finally:
        jeng.stop()


_VERIFY_RANK = """
import dataclasses
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from production_stack_tpu_torch.engine.model_loader import load_model
from production_stack_tpu_torch.parallel.group import TPGroup
from production_stack_tpu_torch.parallel.pipeline import stage_range

rank, pp, sp = {rank}, {pp}, {sp}
g = TPGroup.init(rank, 1, 1, "gloo", [torch.device("cpu")] * (pp * sp), "tcp://127.0.0.1:{port}", pp=pp, sp=sp)
stage = g.stage if pp > 1 else None
seq = g.seq if sp > 1 else None
params = torch.load({params!r})
_, _, net = load_model({model!r}, device="cpu", params=params, stage=stage, seq=seq)
net.cfg = dataclasses.replace(net.cfg, attn_impl="plain")
t = {{k: torch.from_numpy(v) for k, v in np.load({inputs!r}).items()}}
held = stage_range(net.cfg.num_layers, pp, g.stage.rank)
kp, vp = t["kp"][held.start:held.stop].clone(), t["vp"][held.start:held.stop].clone()
with torch.no_grad():
    logits = net(t["ids"], t["pos"], kp, vp, t["pt"], t["lens"], all_logits=True)
np.savez({out!r}, logits=logits.numpy(), kp=kp.numpy(), vp=vp.numpy(),
         ring=np.array([g.ring_calls, g.relay_calls]))
g.close()
"""


def _verify_inputs():
    """Eight rows of a verify forward (T = 1 + K) after ragged histories:
    row b's current token at position hist[b], its K drafts after it;
    row 5 inactive (positions -1, kv_lens 0), as step_spec feeds a row
    that stopped."""
    rng = np.random.RandomState(29)
    B, T, maxp = 8, 1 + K, 6
    pt = rng.permutation(SMALL["num_pages"])[: B * maxp].reshape(B, maxp).astype(np.int32)
    hist = np.array([4, 16, 30, 8, 0, 23, 11, 20], np.int32)
    pos = (hist[:, None] + np.arange(T)[None, :]).astype(np.int32)
    pos[5] = -1
    lens = np.where(pos[:, 0] >= 0, hist + T, 0).astype(np.int32)
    ids = rng.randint(0, 512, (B, T)).astype(np.int32)
    return dict(input_ids=ids, positions=pos, page_table=pt, kv_lens=lens)


def _jax_verify(mesh):
    """The JAX forward with all_logits on ``mesh``, jitted (its Pallas
    kernels in interpret mode)."""
    cfg = dataclasses.replace(jllama.PRESETS[MODEL], attn_impl="pallas_interpret")
    return jax.jit(lambda p, *a: jllama.forward(p, cfg, *a, mesh=mesh, all_logits=True))


@pytest.fixture(scope="module")
def verify_runs(eight_devices, jax_params):
    """The verify forward through the port's rank processes at every
    VERIFY_MESHES layout (all sets at once), and the JAX forward with
    all_logits on the same meshes and pools."""
    cfg = jllama.PRESETS[MODEL]
    kp, vp = _pools(cfg)
    common = _verify_inputs()
    out = {"pools": (kp, vp), "common": common}
    with tempfile.TemporaryDirectory() as tmp:
        params = os.path.join(tmp, "params.pt")
        torch.save(params_from_jax(jax_params, tllama.PRESETS[MODEL]), params)
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, kp=kp, vp=vp, ids=common["input_ids"], pos=common["positions"], pt=common["page_table"],
                 lens=common["kv_lens"])
        procs = {}
        for tag, (pp, sp) in VERIFY_MESHES.items():
            port = free_port()
            for rank in range(pp * sp):
                path = os.path.join(tmp, f"{tag}_r{rank}.npz")
                script = _VERIFY_RANK.format(root=ROOT, rank=rank, pp=pp, sp=sp, port=port, params=params,
                                             model=MODEL, inputs=inputs, out=path)
                procs[(tag, rank)] = (subprocess.Popen([sys.executable, "-c", script], stderr=subprocess.PIPE,
                                                       text=True), path)
        ranks = {}
        for key, (p, path) in procs.items():
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            ranks[key] = dict(np.load(path))
    for tag, (pp, sp) in VERIFY_MESHES.items():
        jl, jk, jv = _jax_verify(make_mesh(pp=pp, sp=sp))(jax_params, common["input_ids"], common["positions"], kp, vp, common["page_table"],
                       common["kv_lens"])
        out[tag] = ([ranks[(tag, r)] for r in range(pp * sp)], (np.asarray(jl), np.asarray(jk), np.asarray(jv)))
    return out


@pytest.mark.parametrize("tag", list(VERIFY_MESHES))
def test_the_verify_forward_matches_the_jax_forward_with_all_logits(verify_runs, tag):
    """Every position's logits of every rank within 2e-5 of the JAX
    forward's at the mesh, the stages' written slots (their layers joined)
    within 2e-5 of the JAX pools', every other slot byte for byte as it
    was, the sequence ranks of a stage the same pool bytes; at sp the ring
    ran (the verify chunk padded from 5 to 6 tokens, 3 a rank) and at pp
    the relays."""
    pp, sp = VERIFY_MESHES[tag]
    ranks, (jl, jk, jv) = verify_runs[tag]
    kp, vp = verify_runs["pools"]
    common = verify_runs["common"]
    assert jl.shape == (8, 1 + K, tllama.PRESETS[MODEL].vocab_size)
    written = _written_slots(common, kp)
    assert written.sum() == (common["positions"] >= 0).sum()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["logits"], jl, **F32)
        assert (res["ring"][0] > 0) == (sp > 1) and (res["ring"][1] > 0) == (pp > 1)
    for name, want, before in (("kp", jk, kp), ("vp", jv, vp)):
        got = np.concatenate([ranks[p * sp][name] for p in range(pp)], axis=0)
        np.testing.assert_allclose(got, want, **F32)
        assert np.array_equal(got[:, ~written].view(np.uint32), before[:, ~written].view(np.uint32))
        for p in range(pp):
            assert all(ranks[p * sp + s][name].tobytes() == ranks[p * sp][name].tobytes() for s in range(sp))
