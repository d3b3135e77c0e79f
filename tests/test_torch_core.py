"""The port's bytes plane against the reference's, on the CPU: the NQE wire
format, the CoreEngine switch (routing, admission, ledgers, the tenant
lifecycle), the compression codecs and the ``nk_*`` boundary.

Both packages get the same op streams, made from a seed with numpy; every
comparison here is exact (ledgers are integers and the floats on the path
are the same IEEE operations in the same order), except where a tolerance
is stated. Collectives across ranks are held against the reference in
``tests/test_torch_nsm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import engine as jeng
from repro.core import nqe as jnqe
from repro.control.sim import _Payload as JPayload
from repro_torch.control.sim import _Payload as TPayload
from repro_torch.core import collectives as tcoll
from repro_torch.core import compression as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import nqe as tnqe

from _torch_threads import one_thread  # noqa: F401

DTYPES = ["float32", "bfloat16", "int8", "int32", "float16"]
AXES = [(), ("pod",), ("data",), ("model",), ("pod", "data"),
        ("pod", "data", "model"), ("stage",)]


def _pair(shape, dtype, seed=0):
    """The same values as a jax array and a torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape) * 3
    j = jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------------------
# NQE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_nqe_equals_reference(dtype):
    """Every verb x axes x flags, for a payload of each dtype: the same
    descriptor string, payload bytes and 32 packed bytes."""
    j, t = _pair((3, 4, 5), dtype)
    assert tnqe.describe(t) == jnqe.describe(j) == f"{dtype}[3,4,5]"
    assert tnqe.payload_bytes(t) == jnqe.payload_bytes(j) == \
        60 * t.element_size()
    for verb in jnqe.VERBS:
        for axes in AXES:
            for flags in range(4):
                kw = dict(verb=verb, axes=axes, tenant_id=7, tag=0xBEEF,
                          op_data=flags * 3, flags=flags)
                jop = jnqe.CommOp(size_bytes=jnqe.payload_bytes(j),
                                  shape_desc=jnqe.describe(j), **kw)
                top = tnqe.CommOp(size_bytes=tnqe.payload_bytes(t),
                                  shape_desc=tnqe.describe(t), **kw)
                assert top.pack() == jop.pack()
                assert tnqe.CommOp.unpack(jop.pack(), expect_shape=
                                          top.shape_desc) == top
    assert tnqe.NQE_SIZE == 32 and tnqe.VERBS == jnqe.VERBS
    assert tnqe.AXIS_BITS == jnqe.AXIS_BITS


def test_payload_bytes_of_tensors_and_duck_payloads():
    """bf16 is 2 bytes an element (``np.dtype`` of a torch dtype would
    have raised and counted 0); the sim's duck payload counts its shape;
    anything else is 0, as in the reference."""
    t = torch.zeros((5, 7), dtype=torch.bfloat16)
    assert tnqe.payload_bytes(t) == 2 * t.numel() == 70
    assert tnqe.payload_bytes(TPayload(123)) == \
        jnqe.payload_bytes(JPayload(123)) == 123
    assert tnqe.describe(TPayload(9)) == jnqe.describe(JPayload(9))
    assert tnqe.payload_bytes(object()) == jnqe.payload_bytes(object()) == 0
    assert tnqe.describe(object()) == jnqe.describe(object())


# ---------------------------------------------------------------------------
# CoreEngine: one op stream through both switches
# ---------------------------------------------------------------------------


def _stream(seed, n=240):
    """(verb, axes, tenant, shape, dtype, flags, op_data, dt) per op."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((jnqe.VERBS[rng.integers(len(jnqe.VERBS))],
                    AXES[rng.integers(1, len(AXES))],
                    int(rng.integers(0, 4)),
                    (int(rng.integers(1, 64)), int(rng.integers(1, 512))),
                    DTYPES[rng.integers(len(DTYPES))],
                    int(rng.integers(0, 4)), int(rng.integers(0, 4)),
                    float(rng.uniform(0.0, 0.02))))
    return out


def _drive(nqe, engine, stream, make):
    """Admit and route a stream through ``engine`` on a virtual clock,
    with rates set, retargeted and cleared along the way."""
    now = 0.0
    for i, (verb, axes, tenant, shape, dtype, flags, op_data, dt) in \
            enumerate(stream):
        now += dt
        if i == 20:
            engine.set_tenant_rate(1, 2e5)
            engine.set_tenant_rate(2, 0.0, burst=1e3)
        if i == 120:
            engine.update_tenant_rate(1, 5e4, burst=2e4, now=now)
            engine.update_tenant_rate(3, 1e6, now=now)
        x = make(shape, dtype, i)
        if verb == "shm_move":
            engine.dispatch(verb, x, axes, tenant_id=tenant, tag=i,
                            flags=flags, op_data=op_data, now=now)
            continue
        op = nqe.CommOp(verb=verb, axes=axes, tenant_id=tenant, tag=i,
                        flags=flags, op_data=op_data,
                        size_bytes=nqe.payload_bytes(x),
                        shape_desc=nqe.describe(x))
        engine.admit(op, now)
        engine.route(op)
    return now


def _j_make(shape, dtype, seed):
    return jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))


def _t_make(shape, dtype, seed):
    return torch.empty(shape, dtype=getattr(torch, dtype))


def _view(e):
    """Everything the switch keeps, in plain Python values."""
    ledger, deferred = e.snapshot()
    return {"ledger": ledger, "deferred": deferred,
            "admitted": e.admit_snapshot(),
            "admit_wait_s": dict(e.admit_wait_s),
            "throttle_log": list(e.throttle_log),
            "billed": dict(e.billed), "route_log": list(e.route_log),
            "buckets": {t: b.snapshot() for t, b in e.buckets.items()},
            "table": e.ledger_table(), "total": e.total_bytes(),
            "deferred_total": e.deferred_bytes(),
            "live": {f: e.live_counters(f) for f in e.ledger_fields},
            "truth": e.ground_truth_map()}


@pytest.mark.parametrize("mode", ["off", "account", "defer"])
@pytest.mark.parametrize("policy", ["xla", "ring", "hierarchical",
                                    "compressed", "shm-first"])
def test_engines_keep_equal_ledgers(mode, policy):
    """The same op stream through both CoreEngines (every stock policy,
    every enforcement mode; ``defer`` on a virtual clock, so nothing
    sleeps) leaves equal ledgers, deferred and admitted counters, shaping
    waits, throttle and route logs (the packed NQEs and the NSM chosen
    for each), billed ground truth and bucket levels."""
    stream = _stream(len(mode) * 31 + len(policy))
    je = jeng.make_engine(None, policy)
    te = teng.make_engine(None, policy)
    je.set_enforcement(mode)
    te.set_enforcement(mode)
    _drive(jnqe, je, stream, _j_make)
    _drive(tnqe, te, stream, _t_make)
    jv, tv = _view(je), _view(te)
    assert tv == jv
    assert len(tv["route_log"]) == len(stream)
    if mode != "off":
        assert tv["throttle_log"] and tv["admitted"]


def test_policies_route_every_op_to_the_same_nsm():
    for policy in ("xla", "ring", "hierarchical", "compressed",
                   "shm-first"):
        je, te = jeng.make_engine(None, policy), teng.make_engine(None,
                                                                   policy)
        for verb, axes, tenant, shape, dtype, flags, op_data, _ in \
                _stream(5, 400):
            kw = dict(verb=verb, axes=axes, tenant_id=tenant, flags=flags,
                      op_data=op_data,
                      size_bytes=int(np.prod(shape)) * 4096)
            assert te.route(tnqe.CommOp(**kw)).name == \
                je.route(jnqe.CommOp(**kw)).name
    with pytest.raises(ValueError):
        teng.make_engine(None, "nope")
    with pytest.raises(KeyError):
        teng.CoreEngine().add_rule("bad", lambda op: True, "no-such-nsm")


def _state(s):
    return dataclasses.asdict(s)


def test_tenant_lifecycle_round_trips_and_equals_reference():
    """Export/import, snapshot/restore, crash and ground truth, on both
    engines after the same stream: equal ``TenantState``s, billed bytes
    conserved across a move, refusals where the reference refuses."""
    stream = _stream(9)
    pairs = []
    for mod, nqe, make in ((jeng, jnqe, _j_make), (teng, tnqe, _t_make)):
        src, dst = mod.CoreEngine(enforcement="account"), \
            mod.CoreEngine(enforcement="account")
        now = _drive(nqe, src, stream, make)
        snap = src.snapshot_tenant(1, now)
        billed = src.billed_ground_truth(1)
        live = {f: src.live_counter(1, f) for f in src.ledger_fields}
        assert dst.has_tenant(1) is False
        exported = src.export_tenant(1, now)
        assert not src.has_tenant(1)
        dst.import_tenant(1, exported, now + 0.5)
        with pytest.raises(ValueError, match="quiesced"):
            dst.import_tenant(1, exported)
        # billed bytes stay where they were routed; carried = live before
        assert src.billed_ground_truth(1) == billed
        assert {f: exported.carried[f] for f in src.ledger_fields} == \
            pytest.approx(live)
        crashed = mod.CoreEngine(enforcement="account")
        crashed.restore_tenant(1, snap, now)
        with pytest.raises(ValueError, match="live bytes-plane state"):
            crashed.restore_tenant(1, snap, now)
        crashed.restore_ground_truth(1, billed)
        back = crashed.snapshot_tenant(1)
        dst2 = mod.CoreEngine()
        dst2.inherit_ground_truth(src)
        src.crash()
        pairs.append((_state(snap), _state(exported), _state(back),
                      {t: b.snapshot() for t, b in dst.buckets.items()},
                      crashed.ground_truth_map(), dst2.ground_truth_map(),
                      src.ground_truth_map(), src.suspend(),
                      _view(crashed)))
        with pytest.raises(ValueError, match="plane"):
            dst.import_tenant(2, dataclasses.replace(exported,
                                                     plane="serve"))
    assert pairs[1] == pairs[0]
    snap, exported, back = pairs[1][:3]
    assert snap == exported                 # snapshot is a non-destructive
    assert back["carried"] == snap["carried"]    # export; restore is exact
    assert back["payload"] == snap["payload"]


def test_dispatch_needs_a_mesh_for_collectives_and_nk_needs_an_engine():
    """With no mesh an engine routes and accounts but cannot run a
    collective; ``nk_*`` with no engine installed raises (torch has no
    ambient axis context: ROADMAP P7); ``shm_move`` never reaches an NSM."""
    eng = teng.CoreEngine()
    x = torch.ones(4)
    assert eng.dispatch("shm_move", x, ("pod",)) is x
    with pytest.raises(ValueError, match="needs a mesh"):
        eng.dispatch("psum", x, ("pod",))
    assert eng.total_bytes() == 32          # both were routed and billed
    assert tcoll.current_engine() is None
    with pytest.raises(RuntimeError, match="use_engine"):
        tcoll.nk_psum(x, "pod")
    with tcoll.use_engine(eng) as got:
        assert tcoll.current_engine() is got is eng
        with pytest.raises(ValueError, match="needs a mesh"):
            tcoll.nk_grad_sync({"a": [x]}, ("pod",))
    assert tcoll.current_engine() is None


# ---------------------------------------------------------------------------
# compression codecs (single rank)
# ---------------------------------------------------------------------------


def _scaled(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-6, 6, (shape[0], 1)))).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_global_scale_codec_equals_reference_under_jit(seed):
    """``quantize_int8``/``dequantize_int8`` at the absmax scale, the
    round-trip residual and the error-feedback step equal the reference's
    to the bit as it runs on its paths (under jit, where ``/ 127.0`` is a
    multiply by float32(1/127))."""
    x = _scaled(seed, (64, 96))
    res = np.random.default_rng(seed + 50).standard_normal(x.shape).astype(
        np.float32) * 1e-3
    t = torch.from_numpy(x)
    scale_j = jax.jit(lambda v: jnp.maximum(jnp.max(jnp.abs(v)), 1e-30)
                      / 127.0)(x)
    scale_t = tcomp.absmax_scale(t.abs().amax())
    assert scale_t.item() == float(scale_j)
    q_j = jax.jit(jcomp.quantize_int8)(x, scale_j)
    q_t = tcomp.quantize_int8(t, scale_t)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    for dt in ("float32", "bfloat16"):
        d_j = jax.jit(lambda q, s: jcomp.dequantize_int8(
            q, s, getattr(jnp, dt)))(q_j, scale_j)
        d_t = tcomp.dequantize_int8(q_t, scale_t, getattr(torch, dt))
        np.testing.assert_array_equal(d_t.float().numpy(),
                                      np.asarray(d_j.astype(jnp.float32)))
    # residuals: XLA contracts ``q * scale - x`` into one fused
    # multiply-add; the port rounds the product first, so they may differ
    # by one f32 ulp of the dequantized value, and no more
    x_hat = tcomp.dequantize_int8(q_t, scale_t).numpy()
    ulp = np.spacing(np.abs(x_hat))
    r_t = tcomp.int8_roundtrip_residual(t).numpy()
    r_j = np.asarray(jax.jit(jcomp.int8_roundtrip_residual)(x))
    assert (np.abs(r_t - r_j) <= ulp).all()
    yj, rj = jax.jit(jcomp.ef_compress_decompress)(x, res)
    yt, rt = tcomp.ef_compress_decompress(t, torch.from_numpy(res))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (np.abs(rt.numpy() - np.asarray(rj))
            <= np.spacing(np.abs(yt.numpy()))).all()
    for dt in ("float32", "bfloat16", "int8"):
        assert tcomp.compression_ratio(getattr(torch, dt)) == \
            jcomp.compression_ratio(getattr(jnp, dt))


def test_bytes_phase_rehearses_on_a_gloo_world_of_one(monkeypatch):
    """``chip_smoke.py``'s bytes phase on a gloo world of one rank (the
    card runs it on NCCL): every stock policy's ``nk_grad_sync`` of a
    small bf16/f32 pytree equals its plain result (the identity; for
    compressed the int8 round trip at the tensor's own scale, bit for
    bit), ledger bytes equal payload bytes, billed bytes survive a move."""
    import importlib.util
    import pathlib

    import torch.distributed as dist
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    g = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn((40, 64), generator=g).to(torch.bfloat16),
            "w": torch.randn((3, 16, 32), generator=g),
            "norm": torch.randn(64, generator=g).to(torch.bfloat16)}
    rows = cs.phase_bytes(torch, torch.device("cpu"), tree, backend="gloo")
    assert not dist.is_initialized()
    assert [r["policy"] for r in rows] == list(cs.BYTES_POLICIES)
    assert all(r["ok"] for r in rows)
    by = {r["policy"]: r for r in rows}
    assert by["compressed"]["routed_to"] == ["compressed", "xla"]
    assert by["hierarchical"]["routed_to"] == ["hierarchical", "xla"]
