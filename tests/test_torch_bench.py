"""The port's bench harness, ``cli/bench.py``, on the CPU (plain kernel
versions, no card).

- ``KEYS`` is the key list of the JAX package's ``bench.py`` line, read from
  its source with ``ast`` (nothing of it runs), and the sections' keys
  cover it.
- At quarter resolution with a small pool (2 cm voxels in 8^3 blocks, 2,048
  blocks, a 6-pose sweep), the fused, extraction, SLAM, accuracy and
  compaction sections, and the streaming section on a short corridor that
  still evicts (60 frames of its quarter-resolution run against a 256-block
  pool that evicts from 30 % full, a tick every frame), each return their
  keys with finite values of ``bench.py``'s types and pass its checks.
- The deterministic outputs of the first four sections equal the same
  computation through the JAX package on the CPU (its factories with their
  Pallas kernels in interpret mode, as ``tests/test_torch_device_step.py``
  runs them), on the same rendered frames: ``n_blocks`` exactly; the mesh's
  triangle count exactly, JAX's extraction run on the port's volume carried
  across (``interop.volume_to_numpy``); ``volume_checksum`` (the sum of the
  weights) within 1e-3 relative, since the Pallas kernel reads a
  neighbouring pixel for some 0.015 % of the voxels a frame (B1's
  tolerances there), each such voxel moving the sum by at most one
  observation; the trajectory's ATE, drift and RPE within 0.1 mm (and
  1e-4 rad), from poses within that test's 1e-4, and the least fitness
  within its 1e-3, each plus the key's rounding.
- A section made to raise leaves its keys ``null``, names itself under
  ``"errors"``, and the next section still runs; the entry point then exits
  1. ``--device cuda`` without a card raises.

Left to ``chip_smoke.py`` (on the card, at ``bench.py``'s sizes), since each
costs more than ~10 s here even at the smallest size: the relocalizer's
warmup (~30 s: its dummy attempts' RANSAC over 8,192 hypotheses), the
recorder's keyframes, the offline bundle's logging and ``finalize``, the
cached-warmup process (~25 s: a second interpreter importing torch), the
frame-to-model, pipeline, incremental, two-camera and accumulator sections.
"""

import ast
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.cli import bench
from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=2048,
                   hash_capacity=8192)
ODOMETRY = OdometryConfig(pyramid_iters=(8, 8, 8))
N_SWEEP = 6
N_SLAM = 4
# the parts these tests run, with their sizes
PARTS = (("fused", dict(warm_frames=4)), ("extract", {}), ("slam", dict(n_slam=N_SLAM)),
         ("accuracy", {}), ("compact", {}))
STREAMING = dict(n_quarter=60, step_quarter=0.045, margin_quarter=0.05, n_full=6,
                 step_full=0.045, margin_full=0.05, pool=256, hash_slots=1024, plain_pool=512,
                 plain_hash_slots=2048, check_interval=1, high_water=0.3)
# bench.py's types (every other key is a float)
INTS = {"n_distinct_poses", "n_blocks", "mesh_triangles", "streaming_n_evictions",
        "streaming_fullres_evictions", "f2m_refines_ok", "incremental_pull_bytes_exact",
        "incremental_touched_blocks"}
BOOLS = {"blocks_growing", "extract_overflow", "streaming_overflow"}
STRS = {"metric", "unit", "device"}
DICTS = {"streaming_tick_ms"}
SECTION_KEYS = dict(bench.SECTIONS)


def _inputs(out_dir):
    b = bench.make_inputs("cpu", str(out_dir), 0.25, SMALL, n_sweep=N_SWEEP)
    b.cfg = dataclasses.replace(b.cfg, odometry=ODOMETRY)
    return b


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The parts run once, in bench.py's order: (inputs, keys by section,
    expected launches by section)."""
    b = _inputs(tmp_path_factory.mktemp("bench"))
    out, expect = {}, {}
    for name, kw in PARTS:
        e = collections.Counter()
        out[name] = getattr(bench, f"{name}_section")(b, e, **kw)
        expect[name] = dict(e)
    return b, out, expect


@pytest.fixture(scope="module")
def jax_side(port):
    """The same computations through the JAX package on the same frames."""
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu import config as jcfg
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
    from azurekinect3dreconstruction_tpu.ops.image import rgb_to_intensity
    from azurekinect3dreconstruction_tpu.ops.pallas import tsdf_kernels as jtk
    from azurekinect3dreconstruction_tpu.pipelines import mono_odometry_tsdf as jmono
    from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as jmc
    from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
    from azurekinect3dreconstruction_tpu.utils.evaluation import ate, rpe

    b = port[0]
    jintr = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cfg = jcfg.PipelineConfig(
        tsdf=jcfg.TSDFConfig(**dataclasses.asdict(SMALL)),
        odometry=jcfg.OdometryConfig(pyramid_iters=ODOMETRY.pyramid_iters))
    rays = jpixel_rays(jintr)
    D, C, P = (jnp.asarray(t.numpy()) for t in (b.depths, b.colors, b.poses))
    half = N_SWEEP // 2
    batch = jtk.make_fused_batch_fn(jintr, cfg.tsdf, bench.WORKLIST, bench.STRIDE, True)
    vol = batch(jtsdf.create(cfg.tsdf), D[:half], C[:half], P[:half], rays)
    vol = batch(vol, D[half:], C[half:], P[half:], rays)
    out = {"n_blocks": int(vol.n_blocks), "volume_checksum": float(vol.weight.sum())}
    # the extraction section on the port's volume, carried across
    carried = jtsdf.TSDFVolume(**{k: jnp.asarray(v)
                                  for k, v in interop.volume_to_numpy(b.vol).items()})
    mcells, mtris, E = bench.fitted_budgets(b.vol, b.cfg.tsdf)
    _, _, n_tris, _ = jmc.extract_mesh_arrays(carried, cfg.tsdf, max_cells=mcells,
                                              max_tris=mtris, extract_blocks=E)
    out["mesh_triangles"] = int(n_tris)
    slam = jmono.make_device_slam_batch(jintr, cfg, worklist_size=bench.WORKLIST,
                                        stride=bench.STRIDE, interpret=True)
    intens = jnp.stack([rgb_to_intensity(c) for c in C])
    _, traj, fits = slam(jtsdf.create(cfg.tsdf), jnp.eye(4, dtype=jnp.float32), intens, D, C,
                         rays)
    est = np.asarray(traj, np.float64)
    gt0 = np.linalg.inv(b.sweep[0])
    gt = np.stack([gt0 @ T for T in b.sweep[1:]])
    a, r = ate(est, gt), rpe(est, gt)
    out.update(ate_mm=a["rmse"] * 1e3, drift_mm=a["final_drift"] * 1e3,
               rpe_mm=r["trans_rmse"] * 1e3, rpe_deg=float(np.degrees(r["rot_rmse"])),
               min_fit=float(np.min(np.asarray(fits)[:N_SLAM - 1])))
    return out


def _bench_py_keys():
    """The keys of the dict ``bench.py`` prints, read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no dict")


def _check_types(keys: dict):
    for k, v in keys.items():
        if k in INTS:
            assert type(v) is int, k
        elif k in BOOLS:
            assert type(v) is bool, k
        elif k in STRS:
            assert type(v) is str, k
        elif k in DICTS:
            assert isinstance(v, dict) and all(math.isfinite(x) for x in v.values()), k
        else:
            assert type(v) is float and math.isfinite(v), (k, v)


# -- the keys -------------------------------------------------------------------------


def test_keys_are_bench_py_keys_in_its_order():
    keys = _bench_py_keys()
    assert len(keys) == 61
    assert list(bench.KEYS) == keys


def test_sections_cover_the_keys_once():
    """Every key but ``device`` and the two preview-wire keys comes from
    exactly one section, in bench.py's section order."""
    seen = [k for _, keys in bench.SECTIONS for k in keys]
    assert len(seen) == len(set(seen))
    assert set(seen) | set(bench.PREVIEW_KEYS) | {"device"} == set(bench.KEYS)
    assert not set(seen) & set(bench.PREVIEW_KEYS)
    assert [n for n, _ in bench.SECTIONS][:5] == ["fused", "extract", "slam", "accuracy",
                                                  "sharded"]
    for name, _ in bench.SECTIONS:
        assert callable(getattr(bench, f"{name}_section"))


# -- the sections on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, _ in PARTS])
def test_section_returns_its_keys_of_bench_py_types(port, name):
    _, out, _ = port
    assert set(out[name]) == set(SECTION_KEYS[name])
    _check_types(out[name])


def test_sections_pass_bench_py_checks(port):
    """The fused sweep grows the pool throughout and the extraction does
    not overflow; the SLAM batch tracks every frame; the expected launches
    are bench.py's dispatch counts (B1 once a fused frame, B1 and B2 once a
    tracked frame)."""
    b, out, expect = port
    f = out["fused"]
    assert f["blocks_growing"] is True and f["n_distinct_poses"] == N_SWEEP
    assert f["n_blocks"] == int(b.vol.n_blocks) > 100 and not bool(b.vol.overflow)
    assert f["value"] > 0 and f["fps_cold_scanning"] > 0 and f["volume_checksum"] > 0
    assert out["extract"]["extract_overflow"] is False and out["extract"]["mesh_triangles"] > 1000
    assert out["slam"]["min_odometry_fitness"] > 0.3
    assert out["accuracy"]["slam_ate_rmse_mm"] <= 20.0
    assert out["compact"]["evict_compact_ms"] > 0
    half = N_SWEEP // 2
    assert expect["fused"] == {tk.KERNEL: 4 + 4 * N_SWEEP + 9 * half}
    assert expect["slam"] == {tk.KERNEL: 9 * (N_SLAM - 1), odo.KERNEL: 9 * (N_SLAM - 1)}
    assert expect["accuracy"] == {tk.KERNEL: N_SWEEP - 1, odo.KERNEL: N_SWEEP - 1}
    assert expect["extract"] == expect["compact"] == {}


def test_streaming_section_on_a_short_corridor_evicts(tmp_path):
    """The streaming section at a short corridor: evictions, no overflow,
    the plain comparator holding it all, finite rates and tick stages."""
    b = _inputs(tmp_path)
    e = collections.Counter()
    out = bench.streaming_section(b, e, **STREAMING)
    assert set(out) == set(SECTION_KEYS["streaming"])
    _check_types(out)
    assert out["streaming_n_evictions"] > 0 and out["streaming_overflow"] is False
    assert out["streaming_fps"] > 0 and out["corridor_plain_fps"] > 0 and out["streaming_tick_ms"]
    n_q, n_f = STREAMING["n_quarter"], STREAMING["n_full"]
    assert dict(e) == {tk.KERNEL: 4 * n_q + 2 * n_f, odo.KERNEL: 4 * (n_q - 1) + 2 * (n_f - 1)}


# -- against the JAX package -----------------------------------------------------------


def test_fused_section_matches_jax(port, jax_side):
    """``n_blocks`` exactly; ``volume_checksum`` within 1e-3 relative."""
    f = port[1]["fused"]
    assert f["n_blocks"] == jax_side["n_blocks"]
    assert f["volume_checksum"] == pytest.approx(jax_side["volume_checksum"], rel=1e-3)


def test_extract_section_matches_jax_on_the_same_volume(port, jax_side):
    assert port[1]["extract"]["mesh_triangles"] == jax_side["mesh_triangles"]


def test_slam_and_accuracy_sections_match_jax(port, jax_side):
    """Poses within 1e-4 make the ATE, drift and RPE agree within 0.1 mm
    (and 1e-4 rad); fits within 1e-3; each plus the key's rounding."""
    acc = port[1]["accuracy"]
    assert acc["slam_ate_rmse_mm"] == pytest.approx(jax_side["ate_mm"], abs=0.1 + 0.005)
    assert acc["slam_final_drift_mm"] == pytest.approx(jax_side["drift_mm"], abs=0.1 + 0.005)
    assert acc["slam_rpe_trans_mm"] == pytest.approx(jax_side["rpe_mm"], abs=0.1 + 0.0005)
    assert acc["slam_rpe_rot_deg"] == pytest.approx(jax_side["rpe_deg"],
                                                    abs=np.degrees(1e-4) + 5e-5)
    assert port[1]["slam"]["min_odometry_fitness"] == pytest.approx(jax_side["min_fit"],
                                                                    abs=1e-3 + 5e-4)


# -- failures and the entry point ------------------------------------------------------


def test_a_raising_section_leaves_its_keys_null_and_the_next_runs(port, monkeypatch):
    b = port[0]

    def broken(b, expect):
        raise ValueError("made to fail")

    monkeypatch.setattr(bench, "compact_section", broken)
    values, errors = bench.run_sections(b, [("compact", SECTION_KEYS["compact"]),
                                            ("extract", SECTION_KEYS["extract"])])
    assert errors == {"compact": "ValueError: made to fail"}
    assert values["evict_compact_ms"] is None
    assert values["mesh_triangles"] == port[1]["extract"]["mesh_triangles"]


def test_entry_point_prints_every_key_and_exits_1_on_an_error(port, monkeypatch, capsys):
    """``main`` with the inputs of these tests and two sections, the first
    made to raise: one JSON line with every key of bench.py plus
    ``errors``, the failed section's keys null, the next section's filled,
    exit code 1."""
    b = port[0]
    monkeypatch.setattr(bench, "make_inputs", lambda dev, out: b)
    monkeypatch.setattr(bench, "SECTIONS", (("compact", SECTION_KEYS["compact"]),
                                            ("extract", SECTION_KEYS["extract"])))

    def broken(b, expect):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(bench, "compact_section", broken)
    rc = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == [*bench.KEYS, "errors"]
    assert line["errors"] == {"compact": "RuntimeError: made to fail"}
    assert line["device"] == "cpu" and line["evict_compact_ms"] is None
    assert line["mesh_triangles"] == port[1]["extract"]["mesh_triangles"]
    assert all(line[k] is None for k in bench.PREVIEW_KEYS)


def test_imports_neither_jax_nor_the_jax_package():
    """In a process where importing jax or the JAX package fails, the
    entry point imports, and neither is loaded after."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['azurekinect3dreconstruction_tpu'] = None\n"
            "from azurekinect3dreconstruction_tpu_torch.cli import bench\n"
            "bad = [k for k, m in sys.modules.items() if m is not None and (k == 'jax'\n"
            "       or k.startswith(('jax.', 'azurekinect3dreconstruction_tpu.')))]\n"
            "assert not bad, bad\n"
            "print(len(bench.KEYS))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "61"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
