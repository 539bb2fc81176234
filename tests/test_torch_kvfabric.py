"""The port's KV fabric (production_stack_tpu_torch/kvfabric/), a copy of
production_stack_tpu/kvfabric/.

Every case of tests/test_kvfabric.py that is not marked slow, on the port's
copies: the wire format ((pages, scales) frames, integrity quarantine,
version fencing, whole pages over every kv head), frame-to-blob landing, the assembler, the
client and server over loopback (breaker, generation fence, quarantine on
both ends), and transfer-cost peer scoring. The directory puller's fabric
path is in tests/test_torch_kvdirectory.py, a migration's fabric handoff in
tests/test_torch_migration.py. Then frames across the packages:
a frame the JAX package encodes decodes in the port byte for byte, and the
reverse, for f32, bf16 and int8 pages with their scales.
"""

import time

import numpy as np
import pytest

from production_stack_tpu_torch.kvfabric.wire import (
    FABRIC_WIRE_VERSION,
    FabricWireError,
    FrameAssembler,
    decode_frame,
    encode_frame,
    frame_to_blobs,
    verify_frame,
)
from production_stack_tpu_torch.ops import quant


def _fp_pages(n=3, seed=0, L=2, ps=8, KH=4, D=16, dtype=np.float32):
    rng = np.random.RandomState(seed)
    keys = [bytes([i] * 32).hex() for i in range(1, n + 1)]
    ks = [rng.randn(L, ps, KH, D).astype(dtype) for _ in range(n)]
    vs = [rng.randn(L, ps, KH, D).astype(dtype) for _ in range(n)]
    return keys, ks, vs


def _quant_pages(n=3, seed=0, L=2, ps=8, KH=4, D=16):
    keys, ks, vs = _fp_pages(n, seed, L, ps, KH, D)
    qks, sks, qvs, svs = [], [], [], []
    for k, v in zip(ks, vs):
        qk, sk = quant.quantize_page_host(k)
        qv, sv = quant.quantize_page_host(v)
        qks.append(qk), sks.append(sk), qvs.append(qv), svs.append(sv)
    return keys, qks, sks, qvs, svs


class TestFabricWire:
    def test_fp_roundtrip(self):
        keys, ks, vs = _fp_pages()
        frame = decode_frame(encode_frame(keys, ks, vs))
        assert frame["keys"] == keys and not frame["quant"]
        assert frame["layers"] == (0, 2) and frame["nlayers"] == 2
        for (k2, v2, sk2, sv2), k, v in zip(frame["pages"], ks, vs):
            assert np.array_equal(k2, k) and np.array_equal(v2, v)
            assert sk2 is None and sv2 is None

    def test_bf16_roundtrip(self):
        ml_dtypes = pytest.importorskip("ml_dtypes")
        keys, ks, vs = _fp_pages(dtype=ml_dtypes.bfloat16)
        frame = decode_frame(encode_frame(keys, ks, vs))
        for (k2, v2, _, _), k, v in zip(frame["pages"], ks, vs):
            assert k2.dtype == k.dtype and np.array_equal(k2, k)
            assert np.array_equal(v2, v)

    def test_quant_roundtrip_carries_exact_scales(self):
        keys, qks, sks, qvs, svs = _quant_pages()
        frame = decode_frame(encode_frame(keys, qks, qvs, sks, svs))
        assert frame["quant"]
        for (k2, v2, sk2, sv2), qk, sk, qv, sv in zip(
            frame["pages"], qks, sks, qvs, svs
        ):
            assert k2.dtype == np.int8 and np.array_equal(k2, qk)
            assert np.array_equal(v2, qv)
            assert np.array_equal(sk2, sk) and np.array_equal(sv2, sv)

    def test_bit_flip_quarantined(self):
        keys, ks, vs = _fp_pages()
        blob = bytearray(encode_frame(keys, ks, vs))
        blob[len(blob) // 2] ^= 0x40
        with pytest.raises(FabricWireError):
            verify_frame(bytes(blob))

    def test_truncation_quarantined(self):
        keys, ks, vs = _fp_pages()
        blob = encode_frame(keys, ks, vs)
        with pytest.raises(FabricWireError):
            verify_frame(blob[:-9])
        with pytest.raises(FabricWireError):
            verify_frame(blob[:2])

    def test_future_version_refused(self):
        """A reader must refuse (never misparse) frames from a newer fleet."""
        import json
        import struct

        blob = encode_frame(*_fp_pages())
        (hlen,) = struct.unpack(">I", blob[:4])
        hdr = json.loads(blob[4 : 4 + hlen])
        hdr["fv"] = FABRIC_WIRE_VERSION + 1
        enc = json.dumps(hdr).encode()
        forged = struct.pack(">I", len(enc)) + enc + blob[4 + hlen :]
        with pytest.raises(FabricWireError):
            verify_frame(forged)

    def test_layer_window_must_match_shape(self):
        keys, ks, vs = _fp_pages(L=4)
        with pytest.raises(ValueError):
            encode_frame(keys, ks, vs, layers=(0, 2))

    def test_quant_frames_need_scales_per_page(self):
        keys, qks, sks, qvs, svs = _quant_pages()
        with pytest.raises(ValueError):
            encode_frame(keys, qks, qvs, sks[:-1], svs)


class TestFabricWholePages:
    """Frames carry whole logical pages over ALL kv heads, as tier blobs do:
    the runner's page calls gather a tp engine's head shards before the
    frame is made and slice them again on restore, so what crosses the wire
    does not depend on how either side shards its pool. Every kv-head count
    a preset serves round-trips byte for byte, with its per-head scales."""

    @pytest.mark.parametrize("KH", [1, 2, 4, 8])
    def test_quant_frame_round_trips_every_head(self, KH):
        keys, qks, sks, qvs, svs = _quant_pages(n=2, KH=KH)
        frame = decode_frame(encode_frame(keys, qks, qvs, sks, svs))
        for (k2, v2, sk2, sv2), k, v, sk, sv in zip(frame["pages"], qks, qvs, sks, svs):
            assert k2.shape[2] == KH and sk2.shape == (k.shape[0], KH)
            assert k2.tobytes() == k.tobytes() and v2.tobytes() == v.tobytes()
            assert sk2.tobytes() == sk.tobytes() and sv2.tobytes() == sv.tobytes()

    @pytest.mark.parametrize("KH", [1, 2, 4, 8])
    def test_fp_frame_round_trips_every_head(self, KH):
        keys, ks, vs = _fp_pages(n=2, KH=KH)
        frame = decode_frame(encode_frame(keys, ks, vs))
        for (k2, v2, sk2, sv2), k, v in zip(frame["pages"], ks, vs):
            assert sk2 is None and sv2 is None and k2.shape[2] == KH
            assert k2.tobytes() == k.tobytes() and v2.tobytes() == v.tobytes()

class TestFrameToBlobs:
    """Fabric-delivered pages land as ordinary tier blobs, so the serde's
    cross-dtype contract covers fp<->int8 engine pairs at the connector
    boundary exactly as it does for shared-tier blobs."""

    def test_fp_frame_lands_as_v2_blobs(self):
        from production_stack_tpu_torch.kvoffload import serde as serde_mod

        keys, ks, vs = _fp_pages()
        frame = decode_frame(encode_frame(keys, ks, vs))
        blobs = frame_to_blobs(frame, serde_mod.NaiveSerde())
        assert [k for k, _ in blobs] == keys
        for (_, blob), k, v in zip(blobs, ks, vs):
            assert serde_mod.verify_blob(blob)["v"] == 2
            k2, v2 = serde_mod.deserialize(blob)
            assert np.array_equal(k2, k) and np.array_equal(v2, v)

    def test_quant_frame_lands_as_v3_scales_verbatim(self):
        from production_stack_tpu_torch.kvoffload import serde as serde_mod

        keys, qks, sks, qvs, svs = _quant_pages()
        frame = decode_frame(encode_frame(keys, qks, qvs, sks, svs))
        # receiver serde is fp ("naive") — quant frames must STILL land as
        # v3 blobs with their scales verbatim, never a lossy re-encode
        blobs = frame_to_blobs(frame, serde_mod.NaiveSerde())
        for (_, blob), qk, sk, qv, sv in zip(blobs, qks, sks, qvs, svs):
            assert serde_mod.verify_blob(blob)["v"] == 3
            qk2, sk2, qv2, sv2 = serde_mod.get_serde(
                "int8page"
            ).deserialize_quant(blob)
            assert np.array_equal(qk2, qk) and np.array_equal(sk2, sk)
            assert np.array_equal(qv2, qv) and np.array_equal(sv2, sv)

    def test_quant_blob_readable_by_fp_engine(self):
        """int8 producer -> fp consumer: the landed v3 blob dequantizes
        through the generic fp entry point (cross-dtype contract)."""
        from production_stack_tpu_torch.kvoffload import serde as serde_mod

        keys, qks, sks, qvs, svs = _quant_pages(n=1)
        frame = decode_frame(encode_frame(keys, qks, qvs, sks, svs))
        (_, blob), = frame_to_blobs(frame, serde_mod.NaiveSerde())
        k2, _v2 = serde_mod.deserialize(blob)
        deq = quant.dequantize_page_host(qks[0], sks[0])
        # v3 blobs restore in the reader's fp dtype (bf16 default): compare
        # at that precision — the quantized bytes themselves are exact
        np.testing.assert_allclose(
            np.asarray(k2, np.float32), deq.astype(k2.dtype).astype(np.float32)
        )

    def test_layer_partial_frame_refused(self):
        keys, ks, vs = _fp_pages(L=2)
        frame = decode_frame(
            encode_frame(keys, ks, vs, layers=(0, 2), nlayers=4)
        )
        with pytest.raises(ValueError):
            frame_to_blobs(frame, None)


class TestFrameAssembler:
    def _windows(self, L=4, win=2, quant_pages=False):
        if quant_pages:
            keys, ks, sks, vs, svs = _quant_pages(n=2, L=L)
        else:
            keys, ks, vs = _fp_pages(n=2, L=L)
            sks = svs = None
        frames = []
        for lo in range(0, L, win):
            hi = lo + win
            frames.append(decode_frame(encode_frame(
                keys,
                [k[lo:hi] for k in ks],
                [v[lo:hi] for v in vs],
                [s[lo:hi] for s in sks] if sks else None,
                [s[lo:hi] for s in svs] if svs else None,
                layers=(lo, hi), nlayers=L,
            )))
        return keys, ks, vs, sks, svs, frames

    def test_whole_frame_passes_through(self):
        keys, ks, vs = _fp_pages(n=1)
        asm = FrameAssembler()
        done = asm.add(decode_frame(encode_frame(keys, ks, vs)))
        assert [k for k, _ in done] == keys and not asm._pending

    def test_out_of_order_windows_reassemble(self):
        keys, ks, vs, _, _, frames = self._windows(L=4, win=2)
        asm = FrameAssembler()
        assert asm.add(frames[1]) == []  # layers [2:4] first
        done = dict(asm.add(frames[0]))
        assert set(done) == set(keys) and not asm._pending
        for key, k in zip(keys, ks):
            got_k, got_v, sk, sv = done[key]
            assert np.array_equal(got_k, k) and sk is None and sv is None

    def test_quant_windows_rejoin_scales(self):
        keys, qks, _, sks, svs, frames = self._windows(
            L=4, win=2, quant_pages=True
        )
        asm = FrameAssembler()
        asm.add(frames[0])
        done = dict(asm.add(frames[1]))
        for key, qk, sk in zip(keys, qks, sks):
            got_k, _, got_sk, _ = done[key]
            assert np.array_equal(got_k, qk) and np.array_equal(got_sk, sk)

    def test_pending_bounded_oldest_dropped(self):
        """A producer that dies mid-page must not grow receiver memory:
        beyond max_pending staged keys the oldest partial is dropped
        (counted) — the tier path covers it."""
        asm = FrameAssembler(max_pending=2)
        for i in range(3):
            keys = [bytes([0x40 + i] * 32).hex()]
            _, ks, vs = _fp_pages(n=1, L=4, seed=i)
            asm.add(decode_frame(encode_frame(
                keys, [k[0:2] for k in ks], [v[0:2] for v in vs],
                layers=(0, 2), nlayers=4,
            )))
        assert len(asm._pending) == 2 and asm.dropped_partials == 1


class TestFabricClientServer:
    """Loopback against a real listener: the 4 fabric ops, generation
    fencing, quarantine on both ends, and the per-peer breaker."""

    @pytest.fixture()
    def loop_pair(self):
        from production_stack_tpu_torch.kvfabric.client import KVFabricClient
        from production_stack_tpu_torch.kvfabric.server import KVFabricServer

        keys, ks, vs = _fp_pages(n=4, seed=7)
        resident = {
            key: (k, v) for key, k, v in zip(keys, ks, vs)
        }
        sunk: "dict[str, tuple]" = {}

        def pages_fn(want):
            found = [k for k in want if k in resident]
            if not found:
                return [], b""
            return found, encode_frame(
                found,
                [resident[k][0] for k in found],
                [resident[k][1] for k in found],
            )

        def sink_fn(frame):
            for key, page in zip(frame["keys"], frame["pages"]):
                sunk[key] = page
            return len(frame["keys"])

        srv = KVFabricServer(
            "127.0.0.1", 0, generation=42, quant=False, page_size=8,
            nlayers=2, pages_fn=pages_fn, sink_fn=sink_fn,
        )
        srv.start()
        cli = KVFabricClient(retries=0, timeout=5.0)
        yield cli, srv, resident, sunk
        cli.close()
        srv.stop()

    def test_hello_and_probe(self, loop_pair):
        cli, srv, _, _ = loop_pair
        info = cli.hello(srv.address)
        assert info["generation"] == 42 and info["page_size"] == 8
        assert info["quant"] is False and info["nlayers"] == 2
        link = cli.probe(srv.address)
        assert link.bandwidth > 0 and link.rtt >= 0
        # cached: a second probe is free (no new measurement)
        before = cli.probe_cache.probes
        assert cli.probe(srv.address) is link
        assert cli.probe_cache.probes == before

    def test_pull_resident_pages(self, loop_pair):
        cli, srv, resident, _ = loop_pair
        keys = sorted(resident)[:2]
        frame = cli.pull(srv.address, keys, expect_generation=42)
        assert frame is not None and sorted(frame["keys"]) == keys
        for key, (k2, v2, _, _) in zip(frame["keys"], frame["pages"]):
            k, v = resident[key]
            assert np.array_equal(k2, k) and np.array_equal(v2, v)
        assert srv.served_pages == 2 and cli.pulled_pages == 2
        assert cli.pull_hist._total == 1

    def test_pull_miss_returns_none(self, loop_pair):
        cli, srv, _, _ = loop_pair
        assert cli.pull(srv.address, ["ff" * 32]) is None
        assert cli.pulled_pages == 0

    def test_generation_fence(self, loop_pair):
        """A claim issued by a previous incarnation of the owner must not
        restore from the reborn owner's (reused) pool."""
        cli, srv, resident, _ = loop_pair
        keys = sorted(resident)[:1]
        assert cli.pull(srv.address, keys, expect_generation=41) is None
        assert srv.stale_generation_pulls == 1 and srv.served_pages == 0

    def test_push_lands_in_sink(self, loop_pair):
        cli, srv, _, sunk = loop_pair
        keys, ks, vs = _fp_pages(n=2, seed=9)
        assert cli.push(srv.address, encode_frame(keys, ks, vs))
        assert sorted(sunk) == sorted(keys)
        assert srv.received_pages == 2 and cli.pushed_pages == 2
        assert cli.push_hist._total == 1

    def test_push_preflight_quarantines_locally(self, loop_pair):
        """A frame corrupted before send is refused WITHOUT a network round
        trip — the peer never sees it."""
        cli, srv, _, sunk = loop_pair
        blob = bytearray(encode_frame(*_fp_pages(n=1)))
        blob[len(blob) // 2] ^= 0x40
        assert cli.push(srv.address, bytes(blob)) is False
        assert cli.corrupt_frames == 1
        assert srv.received_pages == 0 and not sunk

    def test_server_quarantines_corrupt_push(self, loop_pair):
        """Bypass the client pre-flight (raw request): the listener must
        CRC-check before the sink ever sees the frame."""
        cli, srv, _, sunk = loop_pair
        blob = bytearray(encode_frame(*_fp_pages(n=1)))
        blob[len(blob) // 2] ^= 0x40
        hdr, _ = cli._request(
            srv.address, {"op": "fabric_push"}, bytes(blob)
        )
        assert not hdr["ok"] and hdr["error"] == "integrity"
        assert srv.corrupt_frames == 1 and not sunk

    def test_breaker_opens_and_fails_fast(self):
        from production_stack_tpu_torch.kvfabric import client as fabric_client
        from production_stack_tpu_torch.kvfabric.client import KVFabricClient

        cli = KVFabricClient(retries=0, timeout=0.5)
        dead = "127.0.0.1:1"
        for _ in range(fabric_client.BREAKER_THRESHOLD):
            assert cli.hello(dead) is None
        assert cli.breaker_open(dead) and cli.breaker_opens == 1
        t0 = time.perf_counter()
        assert cli.pull(dead, ["aa" * 32]) is None
        assert time.perf_counter() - t0 < 0.2, "open breaker must fail fast"
        cli.close()


class TestPeerScoring:
    def test_transfer_cost_score(self):
        from production_stack_tpu_torch.kvfabric.peers import transfer_cost_score

        assert transfer_cost_score(2e9, 0) > transfer_cost_score(1e9, 0)
        assert transfer_cost_score(1e9, 0) > transfer_cost_score(1e9, 4)
        assert transfer_cost_score(1e9, 0, rtt=0.5) < transfer_cost_score(
            1e9, 0, rtt=0.001
        )

    def test_pick_best_peer(self):
        from production_stack_tpu_torch.kvfabric.peers import pick_best_peer

        assert pick_best_peer([]) is None
        # nothing probed yet -> keep the caller's round-robin default
        assert pick_best_peer([("a", 0.0, 0), ("b", 0.0, 3)]) is None
        assert pick_best_peer(
            [("slow", 1e8, 0), ("fast", 1e9, 0), ("queued", 1e9, 8)]
        ) == "fast"

    def test_probe_peer_link_stub_echo(self):
        from production_stack_tpu_torch.kvfabric.peers import probe_peer_link

        def echo(hdr, payload):
            return {"ok": True, "echo": len(payload)}, payload

        bw, rtt = probe_peer_link("stub:0", echo)
        assert bw > 0 and rtt >= 0

    def test_probe_cache_failure_scores_last_and_invalidate_reprobes(self):
        from production_stack_tpu_torch.kvfabric.peers import PeerProbeCache

        calls = []

        def probe(addr):
            calls.append(addr)
            if len(calls) == 1:
                raise ConnectionError("down")
            return 1e9, 0.001

        cache = PeerProbeCache(probe, ttl_s=300.0)
        link = cache.get("p:1")
        assert link.bandwidth == 0.0 and cache.probe_failures == 1
        # cached (even the failure) until invalidated
        assert cache.get("p:1").bandwidth == 0.0 and len(calls) == 1
        cache.invalidate("p:1")
        assert cache.get("p:1").bandwidth == 1e9 and len(calls) == 2




# -- frames across the packages ----------------------------------------------


def _cross_pages(kind, n=3, L=4, seed=5):
    """(keys, ks, vs, sks, svs) for f32, bf16 or int8 pages (int8 with the
    JAX package's quantizer's scales)."""
    from production_stack_tpu.ops import quant as jquant

    keys, ks, vs = _fp_pages(n=n, seed=seed, L=L)
    if kind == "int8":
        qs = [jquant.quantize_page_host(x) for x in ks + vs]
        return keys, [q for q, _ in qs[:n]], [q for q, _ in qs[n:]], [s for _, s in qs[:n]], [s for _, s in qs[n:]]
    if kind == "bf16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        ks = [k.astype(ml_dtypes.bfloat16) for k in ks]
        vs = [v.astype(ml_dtypes.bfloat16) for v in vs]
    return keys, ks, vs, None, None


@pytest.mark.parametrize("layers", [None, (2, 4)], ids=["whole", "window"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frames_cross_the_packages_byte_for_byte(writer, kind, layers):
    """The same pages encode to the same bytes in both packages, and each
    decodes the other's frame to the same pages and scales."""
    from production_stack_tpu.kvfabric import wire as jwire
    from production_stack_tpu_torch.kvfabric import wire as pwire

    keys, ks, vs, sks, svs = _cross_pages(kind)
    if layers is not None:
        lo, hi = layers
        ks, vs = [k[lo:hi] for k in ks], [v[lo:hi] for v in vs]
        sks = [x[lo:hi] for x in sks] if sks else None
        svs = [x[lo:hi] for x in svs] if svs else None
    kw = dict(layers=layers, nlayers=4) if layers else {}
    enc, dec = (jwire, pwire) if writer == "jax" else (pwire, jwire)
    frame = enc.encode_frame(keys, ks, vs, sks, svs, **kw)
    assert frame == dec.encode_frame(keys, ks, vs, sks, svs, **kw)
    got = dec.decode_frame(frame)
    assert got["keys"] == keys and got["quant"] == (kind == "int8")
    assert got["layers"] == (layers or (0, 4)) and got["nlayers"] == 4
    for (k2, v2, sk2, sv2), i in zip(got["pages"], range(len(keys))):
        assert k2.dtype == ks[i].dtype and k2.tobytes() == ks[i].tobytes() and v2.tobytes() == vs[i].tobytes()
        if kind == "int8":
            assert sk2.tobytes() == np.asarray(sks[i], np.float32).tobytes()
            assert sv2.tobytes() == np.asarray(svs[i], np.float32).tobytes()
        else:
            assert sk2 is None and sv2 is None


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_landed_blobs_equal_the_jax_packages(kind):
    """frame_to_blobs in both packages lands the same blobs (the port's
    naive serde into the JAX package's, int8 frames as v3 blobs)."""
    from production_stack_tpu.kvfabric import wire as jwire
    from production_stack_tpu.kvoffload import serde as jserde
    from production_stack_tpu_torch.kvfabric import wire as pwire
    from production_stack_tpu_torch.kvoffload import serde as pserde

    keys, ks, vs, sks, svs = _cross_pages(kind)
    frame = pwire.encode_frame(keys, ks, vs, sks, svs)
    assert pwire.frame_to_blobs(pwire.decode_frame(frame), pserde.NaiveSerde()) == jwire.frame_to_blobs(
        jwire.decode_frame(frame), jserde.NaiveSerde())
