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
            "repro_torch.train.checkpoint", "repro_torch.train.runner"} <= names


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
