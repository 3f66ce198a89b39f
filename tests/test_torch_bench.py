"""The port's benchmark entry points (`cmw_tpu_torch.apps.bench`, `.bench_kkt`,
`.breakdown`) against the repository's `bench.py`, on the CPU at small
sizes (B = 4, KB = 2, reduced SQP / ADMM iterations):

  - `make_params` equals `jax.vmap` of `bench.make_params` in f64 (1e-12);
  - the chain of warm-started solves equals bench.py's (vmapped solve and
    `warm_from` under `lax.scan`) in f64, Riccati and dense (1e-9);
  - `work_per_solve` on Riccati is bench.py's own count (its lines executed
    from its source), and on the dense and fused paths the kernel table's
    counts on bench.py's residual count and JAX's constraint matrix;
  - the CLI prints one line with bench.py's keys (read from its source) and
    numerics_ok true, at the fixed configuration it passes to `run`; `run`
    with `full` (at reduced iterations) writes the extras only to its file;
  - `bench_kkt` and `breakdown` run to their end on `--cpu`; without a card
    and without `--cpu` each of the three raises.

bench.py turns JAX's persistent compile cache on when imported; it is
imported with CMW_NO_CACHE=1 so that it writes no cache.
"""

import ast
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import CentroidalMPCSolver as JaxSolver
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import contacts as JC
from cmw_tpu_torch import convert
from cmw_tpu_torch.apps import bench as TB
from cmw_tpu_torch.apps import bench_kkt, breakdown
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.ops import roofline as R
from cmw_tpu_torch.ops.symv import BLK

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
B, KB = 4, 2
SMALL = dict(sqp_iters=2, admm_iters=8)  # the chains' reduced iterations
F64_TOL = 1e-9  # two f64 solves of the same problem, sums in another order


def _import_bench_py():
    old = os.environ.get("CMW_NO_CACHE")
    os.environ["CMW_NO_CACHE"] = "1"
    try:
        import bench
    finally:
        if old is None:
            del os.environ["CMW_NO_CACHE"]
        else:
            os.environ["CMW_NO_CACHE"] = old
    return bench


jbench = _import_bench_py()


def _bench_main():
    with open(BENCH_PY) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def bench_py_keys():
    """(the headline's keys, its "extra" keys, the keys --full adds), read from
    bench.py's `result = {...}` and `extra["extra"][key] = ...` statements."""
    main = _bench_main()
    result = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    keys = [k.value for k in result.keys]
    extra = result.values[keys.index("extra")]
    added = [t.slice.value for n in ast.walk(main) if isinstance(n, ast.Assign) for t in n.targets
             if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Subscript)
             and getattr(t.value.value, "id", None) == "extra"]
    return set(keys), {k.value for k in extra.keys}, set(added)


def bench_py_riccati_work(cfg):
    """bench.py's own (flops, bytes) of one Riccati solve: the statements of
    its `if use_riccati:` branch (bench.py:143-154) run on cfg."""
    node = next(n for n in ast.walk(_bench_main()) if isinstance(n, ast.If)
                and getattr(n.test, "id", None) == "use_riccati")
    scope = {"cfg": cfg, "n": cfg.n_vars, "m": cfg.n_con}
    exec(compile(ast.Module(body=node.body, type_ignores=[]), BENCH_PY, "exec"), scope)
    return scope["flops_per_solve"], scope["bytes_per_solve"]


def _pushes(n):
    p = np.zeros((n, 3))
    p[:, 1] = np.linspace(-1.0, 1.0, n)
    return p


def _jax_params_f64(jcfg, pushes):
    """jax.vmap of bench.make_params over the pushes, f64 (inside enable_x64)."""
    plan = JC.snap_to_grid(JC.make_alternating_gait(n_steps=8, dtype=np.float64), jcfg.dt)
    return jax.vmap(lambda p: jbench.make_params(jcfg, plan, 1.02, p))(jnp.asarray(pushes, jnp.float64))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif hasattr(tree, "_asdict"):
        yield from _leaves(tree._asdict(), prefix)
    else:
        yield prefix[:-1], np.asarray(tree)


def test_make_params_matches_bench_py():
    jcfg = JF.ergocub_mpc_config()
    with jax.enable_x64(True):
        want = dict(_leaves(_jax_params_f64(jcfg, _pushes(B))))
    got = TB.make_params(ergocub_mpc_config(), torch.as_tensor(_pushes(B)), device="cpu", dtype=torch.float64)
    got = dict(_leaves(convert.solution_to_numpy(got)))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == np.float64, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("kkt", ["riccati", "dense"])
def test_chain_matches_bench_py(kkt):
    kw = dict(SMALL, kkt_impl=kkt)
    jcfg = JF.ergocub_mpc_config(**kw)
    js = JaxSolver(jcfg)
    with jax.enable_x64(True):
        params = _jax_params_f64(jcfg, _pushes(B))
        warm = jax.vmap(lambda _: js.cold_start(jnp.float64))(jnp.arange(B))

        def chain_b(w, _):  # bench.py:74-76
            sol = jax.vmap(js.solve)(params, w)
            return jax.vmap(js.warm_from)(params, sol), (sol.cost, sol.prim_res)

        want = jax.jit(lambda w: jax.lax.scan(chain_b, w, None, length=KB)[1])(warm)
        want = [np.asarray(a) for a in want]
    cfg = ergocub_mpc_config(**kw)
    solver = CentroidalMPCSolver(cfg)
    tp = TB.make_params(cfg, torch.as_tensor(_pushes(B)), device="cpu", dtype=torch.float64)
    got = TB.chain(solver, tp, solver.cold_start(B, device="cpu", dtype=torch.float64), KB)
    for name, g, w in zip(("cost", "prim_res"), got, want):
        assert g.shape == (KB, B) and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=F64_TOL, atol=F64_TOL, err_msg=f"{kkt} {name}")


@pytest.mark.parametrize("kw", [{}, SMALL, dict(horizon=0.6)])
def test_work_per_solve_riccati_is_bench_py(kw):
    assert TB.work_per_solve(ergocub_mpc_config(**kw)) == bench_py_riccati_work(JF.ergocub_mpc_config(**kw))


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_work_per_solve_counts_the_kernel_calls(path):
    """The dense and fused counts: the kernel table's calls, on bench.py's
    residual count (its eval_shape of F.residuals, bench.py:129-133) and
    the non-zeros of JAX's constraint matrix on bench's stage."""
    extra = dict(admm_impl="fused") if path == "fused" else {}
    cfg = ergocub_mpc_config(kkt_impl="dense", **extra)
    jcfg = JF.ergocub_mpc_config(kkt_impl="dense", **extra)
    n, m = cfg.n_vars, cfg.n_con
    plan = JC.snap_to_grid(JC.make_alternating_gait(n_steps=8), jcfg.dt)
    base = jbench.make_params(jcfg, plan, 1.02, jnp.zeros(3))
    nr = int(sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda z: JF.residuals(jcfg, base, z), jnp.zeros(n)))))
    nnz = int(np.count_nonzero(np.asarray(JF.constraint_dense(jcfg, base.stage))))
    inv = R.spd_inverse_work(1, n)
    if path == "fused":
        call, calls = R.admm_fused_work(1, n, m, nnz, cfg.admm_iters), cfg.sqp_iters
        flops = inv[1] + 2 * nr * n * n + calls * call[1]
    else:
        nb = -(-n // BLK)
        call, calls = R.symv_work(1, nb * (nb + 1) // 2, nb * BLK), cfg.sqp_iters * cfg.admm_iters
        flops = inv[1] + 2 * nr * n * n + calls * (call[1] + 4 * nnz)
    assert TB.work_per_solve(cfg) == (flops, inv[0] + calls * call[0])


def test_chip_smoke_keys_are_bench_py():
    keys, extra, _ = bench_py_keys()
    assert chip_smoke.BENCH_KEYS == keys and chip_smoke.BENCH_EXTRA_KEYS == extra


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return out.getvalue().splitlines(), ret


def test_bench_cli_prints_one_line_with_bench_py_keys():
    lines, ret = _run(TB.main, ["--cpu", "--batch", str(B), "--reps", "1"])
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys, extra, _ = bench_py_keys()
    assert set(rec) == keys and set(rec["extra"]) == extra
    assert rec == json.loads(json.dumps(ret))
    ex = rec["extra"]
    assert ex["numerics_ok"] is True and ex["device"] == "cpu"
    cfg = ergocub_mpc_config()
    assert (ex["batch"], ex["sqp_iters"], ex["admm_iters"]) == (B, cfg.sqp_iters, cfg.admm_iters)
    assert rec["metric"] == "batched_mpc_solves_per_s" and np.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] * 0.06)
    flops, nbytes = TB.work_per_solve(cfg)
    assert (ex["model_flops_per_solve"], ex["hbm_bytes_per_solve"]) == (flops, nbytes)
    assert ex["mfu_est"] == pytest.approx(flops * rec["value"] / R.F32_FLOP_PER_S)
    assert ex["hbm_bw_util_est"] == pytest.approx(nbytes * rec["value"] / R.HBM_BYTES_PER_S)


def test_bench_cli_runs_the_fixed_config(monkeypatch):
    """The CLI fixes the configuration (ergocub_mpc_config()) and KB; it
    passes its flags on to `run`."""
    calls = []
    monkeypatch.setattr(TB, "run", lambda *a, **kw: calls.append((a, kw)))
    TB.main(["--cpu", "--batch", "3", "--reps", "2", "--full", "--samples", "7", "--extra-out", "x.json",
             "--profile", "trace"])
    TB.main(["--cpu"])
    assert calls == [((ergocub_mpc_config(), 3), dict(device="cpu", reps=2, full=True, samples=7, extra_out="x.json",
                                                      profile_dir="trace")),
                     ((ergocub_mpc_config(), 512), dict(device="cpu", reps=5, full=False, samples=200, extra_out="",
                                                        profile_dir=""))]
    with pytest.raises(SystemExit):
        TB.main(["--cpu", "--full"])  # --full needs --extra-out


def test_bench_full_writes_the_extras_only_to_the_file(tmp_path):
    path = tmp_path / "extra.json"
    cfg = ergocub_mpc_config(sqp_iters=1, admm_iters=8)
    lines, _ = _run(lambda _: TB.run(cfg, B, device="cpu", chain_len=KB, reps=1, full=True, samples=1,
                                     extra_out=str(path)), None)
    assert len(lines) == 1
    headline = json.loads(lines[0])
    with open(path) as f:
        rec = json.load(f)
    keys, extra, added = bench_py_keys()
    assert set(rec) == keys and set(rec["extra"]) == extra | added
    assert {k: v for k, v in rec.items() if k != "extra"} == {k: v for k, v in headline.items() if k != "extra"}
    assert {k: rec["extra"][k] for k in extra} == headline["extra"]
    ex = rec["extra"]
    assert ex["latency_samples"] == 1 and 0 < ex["single_solve_p50_ms"] <= ex["single_solve_p99_ms"]
    assert ex["bf16_kkt_solves_per_s"] > 0
    cost_p, cost_x = ex["cost_pallas_vs_xla"]
    assert abs(cost_p - cost_x) <= 0.005 * (abs(cost_x) + 1.0)


@pytest.mark.parametrize("which", ["both", "fused"])
def test_bench_kkt_runs_on_the_cpu(which):
    lines, rates = _run(bench_kkt.main, [which, "--cpu", "-b", str(B), "--reps", "1"])
    names = ["dense", "riccati"] if which == "both" else ["fused"]
    assert [line.split()[0] for line in lines[:len(names)]] == names and set(rates) == set(names)
    assert all(r > 0 for r in rates.values())
    for line in lines[:len(names)]:
        assert "solves/s" in line and float(line.split("max prim")[1]) < 1e-2
    if which == "both":
        assert len(lines) == 3 and lines[2].startswith("speedup:")
        assert float(lines[2].split("cost agreement:")[1]) < 1e-3


def test_breakdown_runs_on_the_cpu():
    lines, out = _run(breakdown.main, ["--cpu", "--batch", str(B), "--reps", "1"])
    starts = ["full(2,24)", "sqp2_admm1", "sqp1_admm24", "sqp1_admm1", "per-ADMM-iteration:",
              "second SQP iteration total:", "GN build (jacfwd+JtJ+ata):", "KKT inverse (pallas):",
              "KKT inverse (xla chol):", "residual eval (batched):", "accounted:"]
    assert len(lines) == len(starts) and all(line.startswith(s) for line, s in zip(lines, starts))
    assert all(out[k] > 0 for k in ("full(2,24)", "gn_build", "inverse_pallas", "inverse_xla", "residuals"))


@pytest.mark.parametrize("main", [TB.main, bench_kkt.main, breakdown.main], ids=["bench", "bench_kkt", "breakdown"])
def test_without_a_card_each_raises(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
