"""chip_smoke.py's phases at a tiny size on the CPU mesh, its refusal to
run without a GPU, the compile-cache directory choice, and the mesh
engine's table-axis sizing."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from kcftools_tpu.plugins.get_variations import _TABLE_SHARE, _table_axis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = {"platform": "cpu", "card": "cpu test"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Phase a at a tiny size; later phases reuse its dataset."""
    work = str(tmp_path_factory.mktemp("smoke"))
    rng = np.random.default_rng(0)
    ds = cs.phase_a(work, rng, length=30_000, n_samples=2, **KW)
    return work, rng, ds


def test_phase_a_writes_identical_kcfs(tiny):
    _work, _rng, ds = tiny
    base = os.path.join(ds["dir"], "a")
    for eng in ("dprefix", "device"):
        for s in ("s0", "s1"):
            assert cs.kcf_body(os.path.join(base, eng, f"{s}.kcf")) == \
                cs.kcf_body(os.path.join(base, "hybrid", f"{s}.kcf"))


def test_phase_b_gene_mode(tiny):
    _work, rng, ds = tiny
    cs.phase_b(ds, rng, n_genes=5, **KW)
    out = os.path.join(ds["dir"], "b", "device", "s0.kcf")
    rows = [ln for ln in cs.kcf_body(out) if not ln.startswith(b"#")]
    assert len(rows) == 5


def test_phase_c_multi_slab_shape(tiny):
    work, rng, _ds = tiny
    ds = cs.phase_c(work, rng, length=60_000, window=10_000, **KW)
    assert len(ds["dbs"]) == 2


def test_phase_d_join_exact(tiny):
    cs.phase_d(tiny[2])


def test_phase_multi(tiny, monkeypatch):
    work, rng, _ds = tiny
    import jax

    monkeypatch.delenv("KCFTOOLS_NO_DEVICE_PROBE", raising=False)
    cs.phase_multi(work, rng, n_dev=jax.device_count(), length=30_000,
                   n_samples=2, **KW)


def test_screen_detects_a_differing_kcf(tiny):
    """The byte comparison is live: a changed record fails the check."""
    _work, _rng, ds = tiny
    path = os.path.join(ds["dir"], "a", "dprefix", "s0.kcf")
    with open(path, "rb") as fh:
        lines = fh.readlines()
    body = [i for i, ln in enumerate(lines) if not ln.startswith(b"#")]
    lines[body[0]] = lines[body[0]].replace(b"\t", b"\tX", 1)
    changed = os.path.join(ds["dir"], "changed.kcf")
    with open(changed, "wb") as fh:
        fh.writelines(lines)
    assert cs.kcf_body(changed) != cs.kcf_body(
        os.path.join(ds["dir"], "a", "hybrid", "s0.kcf"))


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied away from the package, the script cannot run at all."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("env_dir", ["/x", None])
def test_compile_cache_dir(env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    p = subprocess.run(
        [sys.executable, "-c",
         "import kcftools_tpu.jaxinit, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr
    want = env_dir or os.path.join(REPO, ".jax_cache")
    assert p.stdout.strip() == want


GB = 1 << 30


@pytest.mark.parametrize(
    "est, n_dev, stats, want",
    [
        (100 * GB, 8, None, 1),  # no stats: whole table per device
        (100 * GB, 8, {}, 1),  # stats without a limit
        (1 * GB, 4, {"bytes_limit": 60 * GB}, 1),
        (20 * GB, 4, {"bytes_limit": 60 * GB}, 2),
        (40 * GB, 4, {"bytes_limit": 60 * GB}, 4),
        (900 * GB, 4, {"bytes_limit": 60 * GB}, 4),  # capped at n_dev
        (int(_TABLE_SHARE * 16 * GB), 8, {"bytes_limit": 16 * GB}, 1),
        (int(_TABLE_SHARE * 16 * GB) + 1, 8, {"bytes_limit": 16 * GB}, 2),
        (40 * GB, 6, {"bytes_limit": 60 * GB}, 2),  # divides n_dev
    ],
)
def test_table_axis(monkeypatch, est, n_dev, stats, want):
    monkeypatch.delenv("KCFTOOLS_TABLE_AXIS", raising=False)
    assert _table_axis(est, n_dev, stats) == want


@pytest.mark.parametrize("env, n_dev, want", [("4", 8, 4), ("16", 8, 8),
                                               ("3", 8, 1), ("2", 6, 2)])
def test_table_axis_env_override(monkeypatch, env, n_dev, want):
    monkeypatch.setenv("KCFTOOLS_TABLE_AXIS", env)
    assert _table_axis(1, n_dev, {"bytes_limit": 60 * GB}) == want


@pytest.mark.gpu
def test_join_exact_on_gpu(gpu, tmp_path):
    ds = cs.build_dataset(str(tmp_path), "g", np.random.default_rng(2),
                          length=200_000, n_samples=1, snp=0.01)
    cs.phase_d(ds)
