"""Multi-host serving of the port (engine/distributed.py: RankBlock,
follower_host_main, resolve_process_id, the secret through the rendezvous
store; parallel/group.py: host blocks; api_server.serve's branch) against the
JAX package's (tests/test_multihost.py; api_server._resolve_process_id,
parallel/mesh.make_mesh).

Two OS processes on the CPU, each running ``api_server.serve`` with process
id 0 or 1 over gloo and loading nothing of JAX, form one engine on the f32
twin with the JAX engine's weights (each host loads its own copy):

- at dp 2 x tp 2 (two ranks a host, the JAX e2e's layout scaled down),
  greedy ids over HTTP equal the JAX engine's at the same mesh; a LoRA load
  reaches the follower host (its log shows the replayed slot write, every
  rank's slots change) and the adapter's ids equal the JAX engine's with it;
  sleep levels 1 and 2 and a wake give the same ids; a spill to the CPU tier
  and its restore give back the pages' bytes, both hosts' replicas alike;
  the KV-index controller sees the leader once; a single-host producer feeds
  the two-host consumer over TCP blobs, with the ids of one engine alone;
- at pp 2 (one stage a host), greedy ids equal the JAX engine's at pp 2;
  the follower host killed, the leader exits 13.

Unit cases: the process id's resolution, each host's rank coordinates
against ``make_mesh``'s positions of its devices, the secret through the
c10d store and a wrong one refused at the handshake, the refusals.
"""

import asyncio
import hashlib
import json
import os
import resource
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch.distributed as dist

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.engine import distributed as tdist
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload import controller
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel.group import host_ranks, rank_place
from production_stack_tpu_torch.testing.procs import free_port
from test_torch_lora_ranks import LORA, write_adapters
from test_torch_surface import _Loop, call

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
MODEL = "llama-debug-4kv-f32"  # 2 layers, NH 8, KH 4
SMALL = dict(max_model_len=128, page_size=8, max_num_seqs=4, decode_steps=2, prefill_chunk=32)
N_TOKENS = 8
# the offload round trip (tests/test_multihost.py _offload_roundtrip): 32
# pages of 8 tokens, prompt A's pages spilled by the fillers and restored
OFFLOAD_PROMPT = "offload me across two hosts please "
FILLERS = [f"filler prompt number {i:02d} with padding text" for i in range(10)]
DISAGG_PROMPT = "a prompt prefilled on one host, decoded on two, "


def _prompts(vocab):
    rng = np.random.RandomState(23)
    return [[int(x) for x in rng.randint(1, vocab, n)] for n in (19, 45)]


# -- the host processes -----------------------------------------------------------

# A host process: api_server.serve with the engine flags and the weights the
# test hands it, jax unimportable. On process 0 (the leader) a probe route on
# a second port runs greedy requests through the engine (their token ids) and
# reads the ranks (digests, a prompt's page bytes); at SIGTERM the leader
# stops, which closes the step stream. Every host prints at exit the JAX
# package's modules it loaded.
_HOST = r"""
import asyncio, atexit, hashlib, json, signal, sys
sys.modules["jax"] = None  # an import of jax raises
atexit.register(lambda: print("LOADED", json.dumps(sorted(
    m for m in sys.modules if m == "production_stack_tpu" or m.startswith("production_stack_tpu."))), flush=True))
args = json.loads(sys.argv[1])


async def main():
    import numpy as np
    import torch
    from aiohttp import web

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    with np.load(args["params"]) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    server, site = await serve(EngineConfig(**args["cfg"]), device="cpu", params=params)
    engine = server.engine
    loop = asyncio.get_running_loop()

    def on_device(fn):
        return loop.run_in_executor(None, engine._run_on_device_thread, fn)

    def hexes(rows):
        return [bytes(r).hex() for r in rows]

    async def greedy(ids, lora):
        out = []
        sp = SamplingParams(max_tokens=args["n"], temperature=0.0, ignore_eos=True)
        async for o in engine.generate(f"probe-{loop.time()}", prompt_token_ids=ids, params=sp, lora_name=lora):
            out += o.token_ids
        return out

    def pages(prompt):
        kv = engine.kv
        pids = [kv.hash_to_page[h] for h in prefix_hashes(engine.tokenizer.encode(prompt), kv.page_size)
                if h in kv.hash_to_page]
        ks, vs = engine.runner.get_pages(pids)
        return [hashlib.sha256(np.asarray(k).tobytes() + np.asarray(v).tobytes()).hexdigest()
                for k, v in zip(ks, vs)]

    async def probe(request):
        body = await request.json()
        op = body["op"]
        if op == "ids":
            prompts = [p if isinstance(p, list) else engine.tokenizer.encode(p) for p in body["prompts"]]
            return web.json_response({"ids": [await greedy(p, body.get("lora")) for p in prompts]})
        if op == "pages":
            return web.json_response({"pages": await on_device(lambda: pages(body["prompt"]))})
        r = engine.runner
        return web.json_response(await on_device(lambda: {
            "labels": [d for d, _ in r.kv_pool_shard_layout()], "replicas": hexes(r.replica_digest()),
            "params": hexes(r.params_digest()), "lora": hexes(r.lora_digest())}))

    app = web.Application()
    app.router.add_post("/probe", probe)
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", args["probe"]).start()
    stop = asyncio.Event()
    loop.add_signal_handler(signal.SIGTERM, stop.set)
    print("READY", flush=True)
    await stop.wait()
    await runner.cleanup()
    await site.cleanup()
    engine.stop()


if __name__ == "__main__":
    asyncio.run(main())
"""


class Hosts:
    """The two host processes of one engine (each its own session, so a
    host's loss takes all its processes), their logs in ``tmp``."""

    def __init__(self, tmp, params_path, mesh: dict, **extra):
        self.http, self.probe_port = free_port(), free_port()
        coord, sync = free_port(), free_port()
        cfg = dict(model=MODEL, host="127.0.0.1", port=self.http, tp_backend="gloo", **SMALL, **mesh,
                   distributed_coordinator=f"127.0.0.1:{coord}", distributed_num_processes=2,
                   worker_sync_port=sync, **extra)
        self.base = f"http://127.0.0.1:{self.http}"
        self.logs = [tmp / f"host{i}.log" for i in (0, 1)]
        self.procs = []
        for i in (0, 1):
            a = dict(cfg=dict(cfg, distributed_process_id=i), params=str(params_path), probe=self.probe_port,
                     n=N_TOKENS)
            with open(self.logs[i], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _HOST, json.dumps(a)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True, env=dict(os.environ, PYTHONPATH=ROOT)))

    def log(self, i: int) -> str:
        return self.logs[i].read_text()

    def wait_ready(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while "READY" not in self.log(0):
            dead = [p.poll() for p in self.procs]
            assert time.monotonic() < deadline and dead == [None, None], \
                f"a host did not start ({dead}):\n{self.log(0)[-3000:]}\n---\n{self.log(1)[-3000:]}"
            time.sleep(0.2)

    def probe(self, **body):
        st, out = call(f"http://127.0.0.1:{self.probe_port}", "POST", "/probe", body)
        assert st == 200, out
        return out

    def stop(self) -> list:
        """SIGTERM to the leader, whose stop closes the stream: both exit
        codes (the follower host's after the leader's), every survivor
        killed."""
        rcs = []
        try:
            if self.procs[0].poll() is None:
                os.killpg(self.procs[0].pid, signal.SIGTERM)
            rcs = [p.wait(timeout=60) for p in self.procs]
        finally:
            for p in self.procs:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait(10)
        return rcs


def _loaded(text: str) -> list:
    return json.loads(text.rsplit("LOADED ", 1)[1].splitlines()[0])


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX engine's seeded weights (seed 0) as the port's, and saved for
    the host processes."""
    tmp = tmp_path_factory.mktemp("multihost")
    params = params_from_jax(jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0))),
                             tllama.PRESETS[MODEL])
    path = tmp / "params.npz"
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return tmp, path, params


def _jax_ids(mesh: dict, requests, adapters=(), extra_prompts=()):
    """The JAX engine's greedy ids at ``mesh`` for ``requests`` ((prompt
    ids, adapter) pairs, in turn) and for ``extra_prompts`` (text)."""
    jeng = JaxEngine(JaxEngineConfig(model=MODEL, num_pages=64, **SMALL, **mesh, **(LORA if adapters else {})))
    try:
        for name, path in adapters:
            jeng.load_lora_adapter(name, path)
        jeng.start()

        async def run(key, prompt, lora=None):
            out = []
            sp = JaxSamplingParams(max_tokens=N_TOKENS, temperature=0.0, ignore_eos=True)
            kw = dict(prompt=prompt) if isinstance(prompt, str) else dict(prompt_token_ids=prompt)
            async for o in jeng.generate(f"j-{key}-{time.monotonic_ns()}", params=sp, lora_name=lora, **kw):
                out += o.token_ids
            return out

        async def all_():
            return ([await run(i, p, lora) for i, (p, lora) in enumerate(requests)],
                    [await run(f"x{i}", p) for i, p in enumerate(extra_prompts)])

        return asyncio.run(all_())
    finally:
        jeng.stop()


# -- the dp 2 x tp 2 cluster ---------------------------------------------------------


@pytest.fixture(scope="module")
def dp_cluster(eight_devices, weights):
    """The two-host dp 2 x tp 2 engine (a disagg consumer, with LoRA, sleep
    mode, a CPU tier and the KV-index controller) and the JAX engine at the
    same mesh, driven in turn; what the tests read."""
    tmp, path, params = weights
    adapters = write_adapters(tmp, tllama.PRESETS[MODEL])
    prompts = _prompts(tllama.PRESETS[MODEL].vocab_size)
    ctl = controller.KVIndexController()
    registers = []
    orig_register = ctl.register
    ctl.register = lambda *a, **kw: (registers.append(a[0]), orig_register(*a, **kw))[1]
    lp = _Loop()
    ctl_port, kv_port = free_port(), free_port()
    ctl_server = lp.run(asyncio.start_server(ctl.handle, "127.0.0.1", ctl_port))
    hosts = Hosts(tmp, path, dict(data_parallel_size=2, tensor_parallel_size=2), num_pages=32, **LORA,
                  enable_sleep_mode=True, kv_offload_cpu_gb=0.001, kv_controller_url=f"127.0.0.1:{ctl_port}",
                  kv_instance_id="mh-engine", advertise_host="127.0.0.1", kv_role="consumer",
                  kv_transfer_port=kv_port)
    res = {"hosts": hosts, "adapters": adapters}
    producer = None
    try:
        # the JAX engine while the hosts start
        requests = [(prompts[0], None), (prompts[1], None), (prompts[0], "a8")]
        res["jax"], (res["jax_disagg"],) = _jax_ids(dict(data_parallel_size=2, tensor_parallel_size=2), requests,
                                                    adapters, [DISAGG_PROMPT])
        hosts.wait_ready()
        res["base"] = hosts.probe(op="ids", prompts=prompts)["ids"]
        res["digests0"] = hosts.probe(op="digests")
        res["loads"] = [call(hosts.base, "POST", "/v1/load_lora_adapter", {"lora_name": n, "lora_path": p})[0]
                        for n, p in adapters]
        res["lora_ids"] = hosts.probe(op="ids", prompts=[prompts[0]], lora="a8")["ids"]
        res["digests1"] = hosts.probe(op="digests")
        res["sleep"] = []
        for level in (1, 2):
            res["sleep"].append([call(hosts.base, "POST", f"/sleep?level={level}", {})[0],
                                 call(hosts.base, "GET", "/is_sleeping")[1]["is_sleeping"],
                                 call(hosts.base, "POST", "/wake_up", {})[0],
                                 hosts.probe(op="ids", prompts=[prompts[0]])["ids"][0]])
        # the offload round trip: A's pages, spilled by the fillers, restored
        hosts.probe(op="ids", prompts=[OFFLOAD_PROMPT])
        res["pages_before"] = hosts.probe(op="pages", prompt=OFFLOAD_PROMPT)["pages"]
        for f in FILLERS:
            hosts.probe(op="ids", prompts=[f])
        res["stats_spilled"] = call(hosts.base, "GET", "/stats")[1]
        res["pages_evicted"] = hosts.probe(op="pages", prompt=OFFLOAD_PROMPT)["pages"]
        hosts.probe(op="ids", prompts=[OFFLOAD_PROMPT])
        res["pages_after"] = hosts.probe(op="pages", prompt=OFFLOAD_PROMPT)["pages"]
        res["stats_restored"] = call(hosts.base, "GET", "/stats")[1]
        # disaggregated prefill: a single-host producer ships the prompt's
        # pages to the consumer's receiver; the consumer's pools dropped
        # first, so its prefix comes from the shipped pages
        producer = LLMEngine(EngineConfig(model=MODEL, host="127.0.0.1", port=free_port(), num_pages=64, **SMALL,
                                          kv_role="producer", kv_peer_url=f"127.0.0.1:{kv_port}"),
                             device="cpu", params=params)
        producer.start()

        async def prefill():
            async for _ in producer.generate("disagg-p", prompt=DISAGG_PROMPT,
                                             params=SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True)):
                pass

        asyncio.run(prefill())
        call(hosts.base, "POST", "/sleep?level=1", {})
        call(hosts.base, "POST", "/wake_up", {})
        hits0 = call(hosts.base, "GET", "/stats")[1]["kv_offload_hit_pages_total"]
        res["disagg"] = hosts.probe(op="ids", prompts=[DISAGG_PROMPT])["ids"][0]
        res["disagg_hits"] = call(hosts.base, "GET", "/stats")[1]["kv_offload_hit_pages_total"] - hits0
        res["digests2"] = hosts.probe(op="digests")
        # the controller: the leader's reporter batches its admits
        tokens = call(hosts.base, "POST", "/tokenize", {"prompt": OFFLOAD_PROMPT})[1]["tokens"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not ctl.lookup(tokens)["matched_chunks"]:
            time.sleep(0.2)
        res["lookup"] = ctl.lookup(tokens)
        res["registers"] = list(registers)
        res["follower_log"] = hosts.log(1)
        res["rcs"] = hosts.stop()
        res["logs"] = [hosts.log(0), hosts.log(1)]
        yield res
    finally:
        if producer is not None:
            producer.stop()
        hosts.stop()
        lp.loop.call_soon_threadsafe(ctl_server.close)
        lp.close()


def test_two_hosts_give_the_jax_engines_greedy_ids_at_dp2_tp2(dp_cluster):
    assert dp_cluster["base"] == dp_cluster["jax"][:2]
    assert all(len(ids) == N_TOKENS for ids in dp_cluster["base"])


def test_every_rank_sits_on_its_host_and_each_host_holds_the_leaders_weights(dp_cluster):
    d = dp_cluster["digests0"]
    assert d["labels"] == ["host0/cpu:0/dp0tp0", "host0/cpu:0/dp0tp1", "host1/cpu:0/dp1tp0", "host1/cpu:0/dp1tp1"]
    # ranks t and t + 2 hold the same tp part, one on each host
    assert d["params"][0] == d["params"][2] and d["params"][1] == d["params"][3]
    assert d["params"][0] != d["params"][1]


def test_a_lora_load_reaches_the_follower_host(dp_cluster):
    assert dp_cluster["loads"] == [200, 200]
    assert "follower replayed set_lora_slot" in dp_cluster["follower_log"]
    assert dp_cluster["lora_ids"] == [dp_cluster["jax"][2]]
    assert dp_cluster["lora_ids"][0] != dp_cluster["base"][0]
    before, after = dp_cluster["digests0"]["lora"], dp_cluster["digests1"]["lora"]
    assert all(a != b for a, b in zip(after, before))  # every rank of both hosts
    assert after[0] == after[2] and after[1] == after[3]


def test_sleep_levels_and_wake_give_the_same_ids(dp_cluster):
    for level, (st_sleep, sleeping, st_wake, ids) in zip((1, 2), dp_cluster["sleep"]):
        assert (st_sleep, sleeping, st_wake) == (200, True, 200), level
        assert ids == dp_cluster["base"][0], level
    for marker in ("drop_kv_pools", "offload_params", "restore_params", "reset_kv"):
        assert f"follower replayed {marker}" in dp_cluster["follower_log"], marker


def test_a_spill_and_its_restore_give_back_the_pages_bytes(dp_cluster):
    before, after = dp_cluster["pages_before"], dp_cluster["pages_after"]
    assert len(before) == (len(OFFLOAD_PROMPT) + 1) // 8 and after == before
    assert len(dp_cluster["pages_evicted"]) < len(before)  # the fillers pushed them out of the pool
    assert dp_cluster["stats_spilled"]["kv_offload_saved_pages_total"] > 0
    assert dp_cluster["stats_restored"]["kv_offload_loaded_pages_total"] > 0
    for marker in ("get_pages", "set_pages"):
        assert f"follower replayed {marker}" in dp_cluster["follower_log"], marker
    # both hosts' dp replicas hold the same pools
    r = dp_cluster["digests2"]["replicas"]
    assert r[0] == r[2] and r[1] == r[3]


def test_the_controller_registers_the_leader_once(dp_cluster):
    assert dp_cluster["registers"] == ["mh-engine"]
    res = dp_cluster["lookup"]
    assert res["instance_id"] == "mh-engine" and res["url"] == dp_cluster["hosts"].base
    assert res["matched_chunks"] >= 1


def test_a_single_host_producer_feeds_the_two_host_consumer(dp_cluster):
    assert dp_cluster["disagg"] == dp_cluster["jax_disagg"]
    assert dp_cluster["disagg_hits"] >= (len(DISAGG_PROMPT) + 1) // 8 - 1


def test_the_hosts_load_nothing_of_jax_and_the_follower_ends_with_the_stream(dp_cluster):
    assert dp_cluster["rcs"] == [0, 0]
    leader, follower = dp_cluster["logs"]
    assert _loaded(leader) == [] and _loaded(follower) == []
    assert "leader shutdown; follower exiting" in follower
    assert "follower rank" not in leader  # no follower was lost


# -- pp 2: one stage a host -----------------------------------------------------------


@pytest.fixture(scope="module")
def pp_cluster(eight_devices, weights):
    tmp, path, _ = weights
    prompts = _prompts(tllama.PRESETS[MODEL].vocab_size)
    hosts = Hosts(tmp, path, dict(pipeline_parallel_size=2), num_pages=64)
    try:
        jax_ids, _ = _jax_ids(dict(pipeline_parallel_size=2), [(p, None) for p in prompts])
        hosts.wait_ready()
        yield hosts, prompts, jax_ids
    finally:
        hosts.stop()


def test_two_hosts_give_the_jax_engines_greedy_ids_at_pp2(pp_cluster):
    hosts, prompts, jax_ids = pp_cluster
    assert hosts.probe(op="ids", prompts=prompts)["ids"] == jax_ids
    d = hosts.probe(op="digests")
    assert d["labels"] == ["host0/cpu:0/pp0tp0", "host1/cpu:0/pp1tp0"]


def test_the_follower_host_killed_ends_the_leader_with_exit_13(pp_cluster):
    """The follower host's loss (every process of it) is seen by the
    leader's watchdog as its stream socket closing: exit 13, at once rather
    than after gloo's timeout."""
    hosts = pp_cluster[0]
    assert hosts.procs[0].poll() is None
    os.killpg(hosts.procs[1].pid, signal.SIGKILL)
    t0 = time.monotonic()
    assert hosts.procs[0].wait(timeout=30) == 13
    assert time.monotonic() - t0 < 15
    assert "the step stream to" in hosts.log(0)


# -- unit cases ----------------------------------------------------------------------


@pytest.mark.parametrize("flag,env,hostname", [
    (3, None, "engine-llama3-0"), (0, "4", "engine-llama3-1"), (None, "5", "engine-llama3-1"),
    (None, None, "engine-llama3-2"), (None, None, "myhost"), (None, "", "pod-7"),
], ids=["flag", "flag-over-env", "env", "ordinal", "no-ordinal", "empty-env"])
def test_the_process_id_resolves_as_the_jax_engine_resolves_it(monkeypatch, flag, env, hostname):
    if env is None:
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    else:
        monkeypatch.setenv("JAX_PROCESS_ID", env)
    monkeypatch.setattr(socket, "gethostname", lambda: hostname)
    got = {}
    for name, fn, cfg in (("jax", jax_server._resolve_process_id, JaxEngineConfig(distributed_process_id=flag)),
                          ("port", tdist.resolve_process_id, EngineConfig(distributed_process_id=flag))):
        try:
            got[name] = fn(cfg)
        except ValueError as e:
            got[name] = str(e)
    assert got["port"] == got["jax"]
    assert isinstance(got["port"], int) == (hostname != "myhost")


@pytest.mark.parametrize("pp,dp,sp,ep,tp", [
    (1, 2, 1, 1, 2), (2, 1, 1, 1, 1), (2, 1, 1, 1, 2), (1, 1, 2, 1, 2), (1, 2, 1, 2, 1), (1, 1, 1, 1, 4),
    (2, 2, 1, 1, 2),
])
def test_each_hosts_ranks_sit_where_make_mesh_puts_its_devices(eight_devices, pp, dp, sp, ep, tp):
    world = pp * dp * sp * ep * tp
    mesh = make_mesh(tp=tp, dp=dp, sp=sp, ep=ep, pp=pp, devices=eight_devices[:world])
    for h in range(2):
        block = host_ranks(world, 2, h)
        want = [tuple(int(x) for x in np.argwhere(mesh.devices == d)[0]) for d in eight_devices[block.start:block.stop]]
        assert [rank_place(r, dp, tp, ep, pp, sp) for r in block] == want, h
    with pytest.raises(ValueError, match="equal blocks"):
        host_ranks(world, 3 if world % 3 else 5, 0)


def test_the_secret_crosses_the_rendezvous_store_and_a_wrong_one_is_refused(monkeypatch):
    monkeypatch.delenv("PSTPU_STEP_SYNC_SECRET", raising=False)
    port = free_port()
    master = dist.TCPStore("127.0.0.1", port, 2, True, wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", port, 2, False)
    got = {}
    reader = threading.Thread(target=lambda: got.setdefault("follower", tdist.resolve_sync_secret(store=client)))
    reader.start()  # blocks until the leader publishes
    leader = tdist.resolve_sync_secret(store=master, leader=True)
    reader.join(10)
    assert got["follower"] == leader and len(leader) == 32
    with pytest.raises(RuntimeError, match="no step-sync secret"):
        tdist.resolve_sync_secret()
    # a follower with another secret is refused at the handshake; one with
    # the leader's joins
    sync = free_port()

    def dial(secret):
        try:
            tdist.follower_loop(None, "127.0.0.1", sync, timeout=10, secret=secret)
        except Exception as e:  # noqa: BLE001 - the refused follower's end is recorded
            got.setdefault("refused", repr(e))

    wrong = threading.Thread(target=dial, args=(b"not-the-leaders",))
    wrong.start()
    with pytest.raises(TimeoutError, match="1 follower"):
        tdist.StepBroadcaster(tdist.listen_socket("127.0.0.1", sync, 1), 1, timeout=3, secret=leader)
    wrong.join(10)
    right = threading.Thread(target=dial, args=(got["follower"],))
    right.start()
    bc = tdist.StepBroadcaster(tdist.listen_socket("127.0.0.1", sync, 1), 1, timeout=10, secret=leader)
    bc.close()
    right.join(10)
    assert not right.is_alive() and not wrong.is_alive()


class _Replayer:
    def __init__(self):
        self.calls = []

    def step(self, *a, **kw):
        self.calls.append("step")

    def set_lora_slot(self, *a, **kw):
        self.calls.append("set_lora_slot")


def test_the_stream_counts_its_bytes_by_method_and_sees_a_follower_go():
    """Every follower's copy of every frame is counted, by the method it
    carries; a follower whose socket closes (its process or host gone) is
    what ``lost`` reports, the leader watchdog's signal."""
    port, secret = free_port(), b"counted"
    replayer = _Replayer()
    t = threading.Thread(target=tdist.follower_loop, args=(replayer, "127.0.0.1", port),
                         kwargs=dict(timeout=10, secret=secret))
    t.start()
    bc = tdist.StepBroadcaster(tdist.listen_socket("127.0.0.1", port, 1), 1, timeout=10, secret=secret)
    assert bc.lost() == []
    # a live follower on a descriptor past select's FD_SETSIZE (1024) is
    # probed like any other: not lost
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft <= 1100:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(hard, 4096), hard))
    low, key = bc._socks[0]
    bc._socks[0] = (socket.socket(fileno=os.dup2(low.fileno(), 1100)), key)
    low.close()
    assert bc.lost() == []
    bc.broadcast("step", (np.zeros((4, 8), np.int32),), {})
    bc.broadcast("set_lora_slot", (1, np.zeros(1 << 16, np.float32)), {})
    assert bc.method_frames == {"step": 1, "set_lora_slot": 1}
    assert bc.method_bytes["set_lora_slot"] > (1 << 18) > bc.method_bytes["step"] > 128
    bc.reset_stats()
    assert (bc.method_frames, bc.method_bytes) == ({}, {})
    # the follower leaves on a close frame sent to it alone: its socket closes
    sock, key = bc._socks[0]
    tdist._send_msg(sock, tdist._pack_call(None, (), {}), key, bc._seq)
    t.join(10)
    deadline = time.monotonic() + 10
    while not bc.lost() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert bc.lost() and replayer.calls == ["step", "set_lora_slot"]
    bc.close()


@pytest.mark.parametrize("kw,words", [
    (dict(distributed_num_processes=2, tensor_parallel_size=2, tp_backend="gloo"),
     "--distributed-num-processes > 1 requires --distributed-coordinator"),
    (dict(distributed_num_processes=2, distributed_coordinator="127.0.0.1:1", tensor_parallel_size=3,
          tp_backend="gloo", model="llama-debug"), "2 processes do not divide the engine's 3 ranks"),
    (dict(distributed_num_processes=2, distributed_coordinator="127.0.0.1:1", tensor_parallel_size=2),
     "NCCL across hosts"),
    (dict(distributed_num_processes=2, distributed_coordinator="leader", tensor_parallel_size=2,
          tp_backend="gloo"), "must be host:port"),
    (dict(distributed_num_processes=2, distributed_coordinator="127.0.0.1:1", tensor_parallel_size=2,
          tp_backend="gloo", kv_role="consumer", kv_transfer_device=True), "device KV transfer"),
    (dict(distributed_num_processes=2, distributed_coordinator="127.0.0.1:1", tensor_parallel_size=2,
          tp_backend="gloo", tp_device_ids="0,0"), "one device index"),
    (dict(distributed_num_processes=2, distributed_coordinator="127.0.0.1:1", tensor_parallel_size=2,
          tp_backend="gloo", distributed_process_id=1), "builds no engine"),
], ids=["no-coordinator", "world-not-divided", "nccl", "bad-coordinator", "device-kv", "device-ids", "follower"])
def test_the_refusals(kw, words):
    with pytest.raises(ValueError, match=words):
        LLMEngine(EngineConfig(**{**dict(model=MODEL, **SMALL), **kw}), device="cpu")


def test_a_two_host_layout_passes_and_its_device_ids_name_one_hosts_ranks():
    cfg = EngineConfig(distributed_num_processes=2, distributed_coordinator="10.0.0.1:8476", data_parallel_size=2,
                       tensor_parallel_size=2, tp_backend="gloo", tp_device_ids="0,1")
    check_supported(cfg)
    assert (cfg.worker_sync_port, cfg.distributed_process_id) == (8477, None)
    assert JaxEngineConfig().worker_sync_port == cfg.worker_sync_port
