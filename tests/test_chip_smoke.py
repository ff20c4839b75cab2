"""chip_smoke.py off the card: its comparisons, its refusal to run without
a GPU, and its phases at toy sizes on the CPU (phase B in plain XLA)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One ray along +x from the origin; sphere 0 is hit dead centre at t=99.5,
# sphere 1 is tangent to the ray (disc = 0: a graze), sphere 2 is missed.
O = np.zeros((1, 3), np.float32)
D = np.array([[1.0, 0.0, 0.0]], np.float32)
C = np.array([[100.0, 0.0, 0.0], [50.0, 0.5, 0.0], [0.0, 50.0, 0.0]],
             np.float32)
R = np.full(3, 0.5, np.float32)


@pytest.mark.parametrize("sid,ref_sid,ok", [
    (0, 0, True),       # agree
    (1, 0, True),       # kernel took the grazing sphere: explained
    (-1, 1, True),      # brute took the graze, kernel missed it
    (2, 0, False),      # a sphere the ray misses: unexplained
    (-1, 0, False),     # missed a clean hit: unexplained
])
def test_compare_closest_classifies_mismatches(sid, ref_sid, ok):
    t = np.array([99.5 if sid == 0 else 50.0], np.float32)
    ref_t = np.array([99.5 if ref_sid == 0 else 50.0], np.float32)
    res = cs.compare_closest(np.array([sid]), t, np.array([ref_sid]), ref_t,
                             O, D, C, R)
    # One ray cannot stay under the 0.01 % mismatch fraction, so judge the
    # classification on its own.
    assert (res["unexplained"] == 0) == ok
    if sid == ref_sid:
        assert res["ok"] and res["id_mismatches"] == 0


def test_compare_closest_mismatch_budget_and_t_tolerance():
    n = 20_000
    o = np.repeat(O, n, 0)
    d = np.repeat(D, n, 0)
    sid = np.zeros(n, np.int64)
    t = np.full(n, 99.5, np.float32)
    res = cs.compare_closest(sid, t, sid.copy(), t.copy(), o, d, C, R)
    assert res["ok"] and res["hit_fraction"] == 1.0
    bad = sid.copy()
    bad[:3] = 1                       # three grazes: over 0.01 % of 20k
    assert not cs.compare_closest(bad, t, sid, t, o, d, C, R)["ok"]
    off = t.copy()
    off[5] *= 1 + 3e-4                # t beyond rtol 1e-4
    res = cs.compare_closest(sid, off, sid, t, o, d, C, R)
    assert not res["ok"] and res["t_max_rel_err"] > cs.T_RTOL


@pytest.mark.parametrize("occ,ref,t_max,ok", [
    (True, True, 500.0, True),
    (True, False, 500.0, True),       # the tangent sphere at t=50: graze
    (True, False, 99.5, True),        # sphere 0 sits exactly at t_max
    (False, True, 200.0, False),      # sphere 0 clearly inside t_max
])
def test_compare_occlusion(occ, ref, t_max, ok):
    c = C if t_max != 200.0 else C[[0, 2]]
    r = R[:c.shape[0]]
    res = cs.compare_occlusion(np.array([occ]), np.array([ref]), O, D, c, r,
                               t_max)
    assert (res["unexplained"] == 0) == ok


@pytest.mark.parametrize("delta,frac,ok", [(0.0, 0.0, True),
                                           (0.5, 1e-4, True),
                                           (0.5, 2e-3, False),
                                           (2e-4, 1.0, False)])
def test_compare_images(delta, frac, ok):
    ref = np.random.default_rng(0).random((100, 100, 3))
    img = ref.copy()
    k = int(frac * 100 * 100)
    img.reshape(-1, 3)[:k] += delta
    if frac == 1.0:
        img = ref + delta
    assert cs.compare_images(img, ref)["ok"] == ok


def test_compare_grads_and_close():
    g = np.array([1.0, -2.0, 0.5])
    assert cs.compare_grads(g + 0.01, g)["ok"]
    assert not cs.compare_grads(g + 0.1, g)["ok"]
    assert not cs.compare_grads(g * np.nan, g)["ok"]
    x = np.array([np.inf, 1.0])
    assert cs.compare_close(x, x.copy(), rtol=0.0)["ok"]
    assert not cs.compare_close(x + [0, 1e-3], x, rtol=1e-4)["ok"]


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "GPU" in out.err


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("phase,kw", [
    ("phase_closest", dict(n_spheres=6000, n_rays=2048, n_check=256)),
    ("phase_closest_10m", dict(n_spheres=6000, n_rays=2048, n_check=256)),
    ("phase_shadow", dict(n_spheres=6000, n_rays=2048, n_check=256)),
    ("phase_render", dict(width=40, height=30, n_big=5000)),
    ("phase_diff", dict(n_spheres=5000, n_rays=1024, n_slice=256)),
])
def test_phase_at_toy_size_on_cpu(phase, kw, capsys):
    res = getattr(cs, phase)(**kw)
    assert res["ok"], res
    line = capsys.readouterr().out.strip().split("\n")[-1]
    name, body = line.split(": ", 1)
    assert json.loads(body)["ok"] is True


def test_phase_four_at_toy_size_on_cpu_mesh(capsys):
    # The four-device phase on four of the suite's virtual CPU devices:
    # mesh, sharded operands, and every comparison it makes on the card.
    res = cs.phase_four(n_big=6000, n_rays=2048, ring_rays=256, n_check=256)
    assert res["ok"], res
    for key in ("train_step", "nearest_hit_sharded", "nearest_hit_ring",
                "fit_microbatched"):
        assert res[key]["ok"], (key, res[key])
    assert res["nearest_hit_sharded"]["operand_devices"]["result"] == \
        [0, 1, 2, 3]
    assert res["fit_microbatched"]["grad_err_vs_f64"]


def test_rel_err():
    assert cs._rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert cs._rel_err([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    assert cs._rel_err([0.0, 1e-3], [0.0, 0.0]) > 1e20   # zero reference
