"""The port stands alone: no JAX, nothing of the reference package.

* Every module of ``repro_torch`` and ``chip_smoke.py`` imports in a
  process where importing ``jax`` fails, and leaves no ``repro`` module
  behind.
* The port's copy of the configs equals the reference's.
* Entry points asked for no device on a machine without a card raise
  instead of falling back to the CPU.
"""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.configs as jconf
import repro_torch.configs as tconf

from _torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_without_jax_or_the_reference():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["ml_dtypes"] = None
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(k for k in sys.modules
                     if k == "repro" or k.startswith("repro."))
        assert not bad, bad
        print(" ".join(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 45                  # every module was walked
    assert {"repro_torch.control.vectorized", "repro_torch.serve.multiplex",
            "repro_torch.serve.replay", "repro_torch.kernels.waterfill",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.models.ssm", "repro_torch.core.nqe",
            "repro_torch.core.engine", "repro_torch.core.nsm",
            "repro_torch.core.compression", "repro_torch.core.collectives",
            "repro_torch.core.overlap", "repro_torch.kernels.quant_comm",
            "repro_torch.control.sim",
            "repro_torch.control.telemetry",
            "repro_torch.control.placement", "repro_torch.serve.cluster",
            "repro_torch.fabric.checkpoint", "repro_torch.obs.timeseries",
            "repro_torch.obs.slo", "repro_torch.data.pipeline",
            "repro_torch.train.optimizer", "repro_torch.train.train_loop",
            "repro_torch.train.checkpoint", "repro_torch.train.runner",
            "repro_torch.launch.mesh", "repro_torch.distribution.sharding",
            "repro_torch.distribution.pipeline"} <= names


def test_family_training_and_encdec_serving_run_without_jax():
    """The slice-12 paths in a process where importing ``jax`` fails: one
    train step of the mamba2, hymba and whisper smoke configs on the CPU
    (``SsdScanFn``, ``FlashAttentionFn``, the encoder), whisper's
    prefill with frames and two decode steps, ``input_specs``; no
    ``repro`` module is loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["ml_dtypes"] = None
        sys.path[:0] = [{str(ROOT / "src")!r}]
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import (RunConfig, ShapeConfig, SHAPES,
                                         get_config, get_smoke_config)
        from repro_torch.data import for_model
        from repro_torch.models import (forward_decode, forward_prefill,
                                        init_params, input_specs)
        from repro_torch.train import make_train_state, make_train_step
        rcfg = RunConfig(attn_q_block=8, attn_kv_block=8, warmup_steps=1,
                         learning_rate=1e-2)
        for arch, seq in (("mamba2-370m", 40), ("hymba-1.5b", 40),
                          ("whisper-small", 20)):
            cfg = get_smoke_config(arch)
            state = make_train_state(cfg, rcfg, device="cpu")
            feed = for_model(cfg, ShapeConfig("t", seq, 2, "train"),
                             device="cpu")
            state, m = make_train_step(cfg, rcfg)(state, feed.batch_at(0))
            assert torch.isfinite(m["loss"]), arch
        cfg = get_smoke_config("whisper-small")
        model = init_params(cfg, device="cpu")
        frames = torch.randn(2, cfg.encoder_seq, cfg.d_model).bfloat16()
        tok = torch.ones((2, 4), dtype=torch.int32)
        logits, caches = forward_prefill(model, tok, rcfg, max_seq=8,
                                         frames=frames)
        for i in range(2):
            logits, caches = forward_decode(
                model, caches, logits.argmax(-1)[:, None].int(),
                torch.full((2,), 4 + i, dtype=torch.int32), rcfg)
        assert torch.isfinite(logits).all()
        specs = input_specs(get_config("whisper-small"), SHAPES["train_4k"])
        assert specs["frames"].device.type == "meta"
        bad = sorted(k for k in sys.modules
                     if k == "repro" or k.startswith("repro."))
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_port_configs_equal_the_reference():
    assert sorted(tconf.ARCHS) == sorted(jconf.ARCHS)
    for name in jconf.ARCHS:
        assert dataclasses.asdict(tconf.get_config(name)) == \
            dataclasses.asdict(jconf.get_config(name)), name
        assert dataclasses.asdict(tconf.get_smoke_config(name)) == \
            dataclasses.asdict(jconf.get_smoke_config(name)), name
        assert tconf.get_config(name).num_params() == \
            jconf.get_config(name).num_params()
    assert dataclasses.asdict(tconf.RunConfig()) == \
        dataclasses.asdict(jconf.RunConfig())
    assert {k: dataclasses.asdict(v) for k, v in tconf.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconf.SHAPES.items()}


def test_port_watchdog_catalog_equals_the_reference():
    """The stock alert rules (names, severities, windows, every setting)
    and the metric-name catalog are the reference's."""
    import repro.obs as jobs
    import repro_torch.obs as tobs
    assert tobs.METRIC_HELP == jobs.METRIC_HELP
    for interval in (0.5, 1.0, 1.2):
        ref, port = jobs.default_rules(interval), \
            tobs.default_rules(interval)
        assert [type(r).__name__ for r in port] == \
            [type(r).__name__ for r in ref]
        for a, b in zip(port, ref):
            assert vars(a).keys() == vars(b).keys(), b.name
            for k, v in vars(b).items():
                got = vars(a)[k]
                if k == "spec":
                    assert dataclasses.asdict(got) == dataclasses.asdict(v)
                else:
                    assert got == v, (b.name, k)
    assert tobs.slo.SEVERITIES == jobs.slo.SEVERITIES
    assert (tobs.slo.SCRAPE_HEADER, tobs.slo.SCRAPE_EOF) == \
        (jobs.slo.SCRAPE_HEADER, jobs.slo.SCRAPE_EOF)
    assert tobs.__all__ == jobs.__all__


def test_port_train_exports_equal_the_reference():
    """The train package exports what the reference's does, the mesh's
    ``state_shardings`` and ``batch_shardings`` included."""
    import repro.train as jtrain
    import repro_torch.train as ttrain
    assert ttrain.__all__ == jtrain.__all__
    assert all(callable(getattr(ttrain, n)) for n in ttrain.__all__)


def test_entry_points_without_a_device_raise_when_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.data import for_model
    from repro_torch.device import resolve_device
    from repro_torch.models import Model, init_cache, init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.train import Runner, make_train_state
    cfg = tconf.get_smoke_config("llama3.2-3b")
    shape = tconf.ShapeConfig("t", 16, 2, "train")
    cpu_feed = for_model(cfg, shape, device="cpu")
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Model(cfg),
                 lambda: init_params(cfg),
                 lambda: init_cache(cfg, 2, 16),
                 lambda: ServeEngine(cfg, tconf.RunConfig()),
                 lambda: for_model(cfg, shape).batch_at(0),
                 lambda: make_train_state(cfg, tconf.RunConfig()),
                 lambda: Runner(cfg, tconf.RunConfig(), None, cpu_feed,
                                str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"   # the explicit ask works


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or with no card, the script exits non-zero
    and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=120, cwd=ROOT))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_attention_ab_refuses_to_run_without_a_card():
    """The kernel timing tool measures the card and has no CPU mode."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "attention_ab.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""


def test_ssd_ab_refuses_to_run_without_a_card():
    """The SSD scan's timing tool measures the card and has no CPU mode."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "ssd_ab.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""


@pytest.mark.parametrize("tool,args", [
    ("ssd_ab.py", ["--shapes", "hymba"]),
    ("ssd_variants.py", ["--set", "heads"]),
    ("simt_routes.py", [])])
def test_ssd_and_simt_tools_refuse_to_run_without_a_card(tool, args):
    """The SSD scan's A/B shapes, its variant copies and the CUDA-core
    routes' timings measure the card: without one each exits 2, prints
    nothing and builds nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / tool), *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
