"""The port's training substrate against ``repro.train``: optimizers, the
data stream, checkpoints (the reference's on-disk layout, both ways), the
manifest codec, the fault-tolerant loop, gradient accumulation, one whole
train step from the reference's state and the training CLI, on the CPU.

Tolerances: the optimizers run the reference's float32 arithmetic, summed
in another order (means and the stacked RMS; XLA contracts multiply-adds
that PyTorch rounds twice): parameters within ``1e-5`` (absolute and
relative) after ``STEPS`` steps on unit-scale trees, optimizer state within
``1e-5`` relative to each leaf's largest magnitude, bf16 parameters within one bf16 ulp (``2 ** -7`` relative) where a
float32 difference may round them apart.  Data, checkpoint bytes and the
manifest codec are compared bit for bit.  A whole train step (smoke
configs, float32): loss and grad norm within ``1e-5`` relative, Adafactor's
parameters within ``1e-5`` and AdamW's within ``ADAM_TOL``: the first
AdamW update is ``lr * g / (|g| + eps)``, ``+-lr`` wherever the gradient is
tiny and its sign may differ, so a parameter may differ by ``2 * lr``.
"""
import pathlib
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models.registry import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import fault_tolerance as ft_mod
from repro_torch.train import msgpack_codec
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts
from repro_torch.train import tree as T
from repro_torch.launch import train as launch_train

from _torch_zoo import pair, train_batches

STEPS = 4
TOL = 1e-5
BF16_REL = 2.0 ** -7
LR = 1e-3
ADAM_TOL = 2.5 * LR

# (shape, dtype, stacked): factored (both trailing dims >= 128) and
# unfactored leaves, a 1-D leaf, bf16 leaves and stacked leaves whose layers
# differ in scale and in density (so Adafactor's update RMS over the whole
# stacked leaf is not any layer's).
LEAVES = {
    "big": ((256, 160), np.float32, False),
    "small": ((16,), np.float32, False),
    "thin": ((100, 200), np.float32, False),
    "bf": ((130, 140), "bfloat16", False),
    "stack": ((3, 128, 144), np.float32, True),
    "stack_bf": ((2, 128, 130), "bfloat16", True),
    "stack_1d": ((3, 40), np.float32, True),
}


def _np_tree(seed, scale_layers=True):
    r = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt, stacked) in LEAVES.items():
        a = r.standard_normal(shape).astype(np.float32)
        if stacked and scale_layers:
            a *= np.asarray([10.0 ** l for l in range(shape[0])],
                            np.float32).reshape((-1,) + (1,) * (len(shape) - 1))
            for l in range(1, shape[0]):    # layer l: 1 in 4 ** l nonzero
                a[l] *= r.random(shape[1:]) < 4.0 ** -l
        out[name] = a.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else a
    return out


def _to_port(tree):
    """The port's tree of a numpy tree: a stacked leaf as its layers."""
    out = {}
    for name, a in tree.items():
        bf = a.dtype.name == "bfloat16"
        t = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
             if bf else torch.from_numpy(a.copy()))
        out[name] = list(t.unbind(0)) if LEAVES[name][2] else t
    return out


def _from_port(leaf):
    ts_ = T.layers(leaf)
    t = torch.stack(ts_) if isinstance(leaf, list) else ts_[0]
    return t.float().numpy()


def _run_both(name, kw, steps=STEPS, stacked=True):
    ropt = getattr(ref_opt, name)(**kw)
    popt = getattr(opt_mod, name)(**kw)
    params = _np_tree(0)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = _to_port(params)
    if not stacked:       # every stacked layer as a leaf of its own
        pp = {f"{k}.{l}" if LEAVES[k][2] else k: t
              for k, v in pp.items()
              for l, t in enumerate(v if LEAVES[k][2] else [v])}
    rs, ps = ropt.init(rp), popt.init(pp)
    upd = jax.jit(ropt.update)
    for i in range(steps):
        grads = _np_tree(100 + i)
        rg = jax.tree_util.tree_map(jnp.asarray, grads)
        rp, rs = upd(rg, rs, rp)
        pg = _to_port(grads)
        if not stacked:
            pg = {f"{k}.{l}" if LEAVES[k][2] else k: t
                  for k, v in pg.items()
                  for l, t in enumerate(v if LEAVES[k][2] else [v])}
        ps = popt.update(pg, ps, pp)
    return rp, rs, pp, ps


def _assert_params_close(rp, pp):
    for name, a in rp.items():
        want = np.asarray(a, np.float32)
        got = _from_port(pp[name])
        bf = np.asarray(a).dtype.name == "bfloat16"
        rtol = BF16_REL if bf else TOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol, err_msg=name)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, warmup_steps=3)),
    ("adamw", dict(lr=3e-3, weight_decay=0.0, b2=0.999, warmup_steps=1)),
    ("adafactor", dict(lr=1e-2, warmup_steps=3)),
    ("adafactor", dict(lr=3e-2, clip_threshold=0.5, decay=0.7)),
])
def test_optimizer_matches_reference(name, kw):
    rp, rs, pp, ps = _run_both(name, kw)
    _assert_params_close(rp, pp)
    assert int(ps["step"]) == int(rs["step"]) == STEPS
    for path, a in T.items(jax.tree_util.tree_map(np.asarray, rs)):
        if path[-1] == "step":
            continue
        np.testing.assert_allclose(T.get(ps, path).numpy(), a, rtol=TOL,
                                   atol=TOL * np.abs(a).max(),
                                   err_msg="/".join(path))
        assert tuple(T.get(ps, path).shape) == a.shape


def test_adafactor_clips_by_the_rms_of_the_whole_stacked_leaf():
    """A stacked leaf's layers at densities 1, 1/4, 1/16: clipping by each
    layer's own RMS is another optimizer, and the reference's is the
    whole leaf's."""
    kw = dict(lr=1e-2, warmup_steps=1)
    rp, _, pp, _ = _run_both("adafactor", kw, steps=1)
    _, _, per_layer, _ = _run_both("adafactor", kw, steps=1, stacked=False)
    want = np.asarray(rp["stack"], np.float32)
    np.testing.assert_allclose(_from_port(pp["stack"]), want, rtol=TOL,
                               atol=TOL)
    split = np.stack([per_layer[f"stack.{l}"].numpy() for l in range(3)])
    assert np.abs(split - want).max() > 1e-3


def test_adafactor_factors_by_the_stacked_shape():
    opt = opt_mod.adafactor()
    st = opt.init(_to_port(_np_tree(0)))
    assert set(st["acc"]["big"]) == {"vr", "vc"}
    assert tuple(st["acc"]["big"]["vr"].shape) == (256,)
    assert tuple(st["acc"]["big"]["vc"].shape) == (160,)
    assert set(st["acc"]["thin"]) == {"v"}          # 100 < 128
    assert tuple(st["acc"]["stack"]["vr"].shape) == (3, 128)
    assert tuple(st["acc"]["stack"]["vc"].shape) == (3, 144)
    assert set(st["acc"]["stack_1d"]) == {"v"}      # (3, 40): 3 < 128
    assert set(st["acc"]["small"]) == {"v"}


def _quad_problem(opt, steps=200):
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    state = opt.init(params)
    for _ in range(steps):
        state = opt.update({"w": 2 * params["w"]}, state, params)
    return float(params["w"].abs().max())


def test_adamw_converges_quadratic():
    assert _quad_problem(opt_mod.adamw(lr=0.1, weight_decay=0.0)) < 0.1


def test_adafactor_converges_quadratic():
    assert _quad_problem(opt_mod.adafactor(lr=0.3), steps=400) < 0.2


def test_adafactor_memory_is_factored():
    opt = opt_mod.adafactor()
    st = opt.init({"big": torch.zeros((256, 512)), "small": torch.zeros(16)})
    assert set(st["acc"]["big"]) == {"vr", "vc"}
    assert tuple(st["acc"]["big"]["vr"].shape) == (256,)
    assert tuple(st["acc"]["big"]["vc"].shape) == (512,)
    assert set(st["acc"]["small"]) == {"v"}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,lo,hi", [(0, 0, None), (7, 0, None),
                                        (5, 3, 7)])
def test_batch_for_step_is_the_references(step, lo, hi):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=3)
    want = ref_data.batch_for_step(ref_data.DataConfig(**kw), step, lo, hi)
    got = data_mod.batch_for_step(data_mod.DataConfig(**kw), step, lo, hi)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_loader_prefetch_matches_reference():
    cfg = data_mod.DataConfig(vocab=50, seq_len=8, global_batch=4)
    loader = data_mod.Loader(cfg, start_step=3)
    it = iter(loader)
    got = [next(it) for _ in range(2)]
    loader.close()
    assert [s for s, _ in got] == [3, 4]
    rcfg = ref_data.DataConfig(vocab=50, seq_len=8, global_batch=4)
    for s, b in got:
        np.testing.assert_array_equal(b, ref_data.batch_for_step(rcfg, s))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "s": [torch.full((2,), 1.5, dtype=torch.bfloat16),
                        torch.full((2,), -2.0, dtype=torch.bfloat16)]},
            "step": torch.tensor(4, dtype=torch.int32)}


def _zeros_like(tree):
    return T.unflatten([(p, [torch.zeros_like(t) for t in leaf]
                         if isinstance(leaf, list) else torch.zeros_like(leaf))
                        for p, leaf in T.items(tree)])


def _assert_same(a, b):
    for (p, x), (_, y) in zip(T.items(a), T.items(b)):
        for u, v in zip(T.layers(x), T.layers(y)):
            assert u.dtype == v.dtype and torch.equal(u, v), p


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), step=10, extra={"global_step": 10})
    target = _zeros_like(t)
    out, extra = ckpt.restore(str(tmp_path), target)
    assert extra["global_step"] == 10
    _assert_same(out, t)
    _assert_same(target, t)         # filled in place


def test_checkpoint_atomic_commit(tmp_path):
    ckpt.save(_tree(), str(tmp_path), step=1)
    (tmp_path / "step_00000002").mkdir()       # not committed: invisible
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_integrity_check(tmp_path):
    p = ckpt.save(_tree(), str(tmp_path), step=1)
    f = sorted(pathlib.Path(p).glob("arr_*.npy"))[0]
    np.save(f, np.load(f) + 1)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), _zeros_like(_tree()))


def test_checkpoint_retention(tmp_path):
    for s in range(6):
        ckpt.save(_tree(), str(tmp_path), step=s, keep_last=2)
    steps = sorted(d.name for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ac.save(t, 5)
    t["a"].add_(100)            # the snapshot was taken before this write
    path = ac.wait()
    assert path and ckpt.latest_step(str(tmp_path)) == 5
    out, _ = ckpt.restore(str(tmp_path), _zeros_like(t))
    assert torch.equal(out["a"], t["a"] - 100)


def _ref_tree(bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return {"params": {"dense": {"w": jnp.arange(24, dtype=jnp.float32)
                                 .reshape(2, 3, 4).astype(dt) / 7},
                       "embed": jnp.linspace(-1, 1, 6).reshape(2, 3)
                       .astype(dt)},
            "opt": {"mu": {"embed": jnp.full((2, 3), 0.25, jnp.float32)},
                    "step": jnp.int32(3)},
            "step": jnp.int32(3)}


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, bf16):
    rt = _ref_tree(bf16)
    ref_ckpt.save(rt, str(tmp_path), step=3, extra={"global_step": 3})
    dt = torch.bfloat16 if bf16 else torch.float32
    target = {"params": {"dense": {"w": [torch.zeros(3, 4, dtype=dt)
                                         for _ in range(2)]},
                         "embed": torch.zeros(2, 3, dtype=dt)},
              "opt": {"mu": {"embed": torch.zeros(2, 3)},
                      "step": torch.zeros((), dtype=torch.int32)},
              "step": torch.zeros((), dtype=torch.int32)}
    _, extra = ckpt.restore(str(tmp_path), target)
    assert extra == {"global_step": 3}
    for path, a in T.items(jax.tree_util.tree_map(np.asarray, rt)):
        leaf = T.get(target, path)
        got = torch.stack(leaf) if isinstance(leaf, list) else leaf
        want = np.asarray(a, np.float32)
        assert np.array_equal(got.float().numpy(), want), path
    # the port writes the same files (bytes) and the same manifest
    port_dir = tmp_path / "port"
    ckpt.save(target, str(port_dir), step=3, extra={"global_step": 3})
    a, b = tmp_path / "step_00000003", port_dir / "step_00000003"
    assert sorted(p.name for p in a.iterdir()) == sorted(
        p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """The reference's fault (ROADMAP.md §C): its bf16 leaf goes to disk as
    '<V2' and its restore cannot cast that back."""
    rt = _ref_tree(True)
    ref_ckpt.save(rt, str(tmp_path), step=3)
    target = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rt)
    with pytest.raises(ValueError, match="No cast function available"):
        ref_ckpt.restore(str(tmp_path), target)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "s": [torch.ones(2), torch.zeros(2)], "step": torch.tensor(
             2, dtype=torch.int32)}
    ckpt.save(t, str(tmp_path), step=2, extra={"global_step": 2})
    target = {"a": jax.ShapeDtypeStruct((2, 3), jnp.float32),
              "s": jax.ShapeDtypeStruct((2, 2), jnp.float32),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    out, extra = ref_ckpt.restore(str(tmp_path), target)
    assert extra == {"global_step": 2}
    np.testing.assert_array_equal(np.asarray(out["s"]), [[1, 1], [0, 0]])
    np.testing.assert_array_equal(np.asarray(out["a"]), t["a"].numpy())


MANIFESTS = [
    {"step": 3, "entries": [{"path": "params/dense/wq", "file": "arr_00000.npy",
                             "shape": [2, 4096, 4096], "dtype": "bfloat16",
                             "crc": 4294967295}], "extra": {}},
    {"step": 0, "entries": [], "extra": {"global_step": 0}},
    {"a": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
           2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
           -2 ** 31, -2 ** 31 - 1, -2 ** 63],
     "f": [0.0, -1.5, 1e300, float("inf")], "b": [True, False, None],
     "s": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é" * 40,
           "v" * 70000],
     "l": list(range(15)), "m": list(range(16)), "n": list(range(70000)),
     "d": {str(i): i for i in range(20)}, "e": {}, "t": (1, [2, (3,)]),
     "by": b"\x00\x01"},
]


@pytest.mark.parametrize("i", range(len(MANIFESTS)))
def test_manifest_codec_is_msgpack(i):
    obj = MANIFESTS[i]
    want = msgpack.packb(obj)
    assert msgpack_codec.packb(obj) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def _toy_step(state, batch):
    new = {"w": state["w"] + batch["x"].sum(), "step": state["step"] + 1}
    return new, {"loss": 1.0 / (new["step"].float() + 1)}


def _toy_state():
    return {"w": torch.tensor(0.0), "step": torch.tensor(0, dtype=torch.int32)}


def test_resilient_loop_restart_resumes(tmp_path):
    ftc = ft_mod.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                          max_retries=0)
    batches = lambda s: {"x": torch.tensor([float(s)])}
    loop = ft_mod.ResilientLoop(_toy_step, _toy_state(), ftc)
    loop.run(batches, 7)
    loop2 = ft_mod.ResilientLoop(_toy_step, _toy_state(), ftc)
    assert loop2.start_step == 7
    final = loop2.run(batches, 10)
    assert int(final["step"]) == 10
    assert float(final["w"]) == sum(range(10))
    # a crash after step 5's checkpoint: restart from it, same answer
    for d in tmp_path.iterdir():
        if d.name != "step_00000005":
            shutil.rmtree(d)
    loop3 = ft_mod.ResilientLoop(_toy_step, _toy_state(), ftc)
    assert loop3.start_step == 5
    assert float(loop3.run(batches, 10)["w"]) == sum(range(10))


def test_resilient_loop_retries_transient_failure(tmp_path):
    calls = {"n": 0}
    msgs = []

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated fabric fault")
        return state, {"loss": torch.tensor(1.0)}

    ftc = ft_mod.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                          max_retries=2, backoff_s=0.01)
    loop = ft_mod.ResilientLoop(flaky, {"w": torch.tensor(0.0)}, ftc,
                                health_cb=msgs.append)
    loop.run(lambda s: {"x": torch.zeros(1)}, 3)
    assert calls["n"] == 4      # 3 steps + 1 retry
    assert any("attempt 0 failed" in m for m in msgs)


def test_straggler_detection():
    sm = ft_mod.StragglerMitigator(ft_mod.FTConfig())
    for _ in range(10):
        assert not sm.record(0.1)
    assert sm.record(1.0)        # 10x p50 -> straggler


def test_failed_step_leaves_the_state_unchanged():
    """A step that raises inside the backward pass changes neither the
    parameters nor the optimizer state, so a retry starts from them."""
    model = Model(get_config("yi-6b", smoke=True))
    params = model.init_params(0, device="cpu")
    state = ts.make_train_state(model, params, ts.TrainConfig())
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    step = ts.build_train_step(model, ts.TrainConfig())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 8)).astype(np.int32))

    def boom(grad):
        raise RuntimeError("fault in the backward pass")
    h = params.final_norm.register_hook(boom)
    with pytest.raises(RuntimeError, match="backward"):
        step(state, {"tokens": toks})
    h.remove()
    for n, p in params.named_parameters():
        assert torch.equal(p, before[n]), n
    assert int(state["opt"]["step"]) == 0
    assert all(float(t.abs().max()) == 0
               for _, t in T.items(state["opt"]["mu"]))


# ---------------------------------------------------------------------------
# gradient accumulation and the CLI
# ---------------------------------------------------------------------------

def test_grad_accumulation_consistency():
    model = Model(get_config("phi4-mini-3.8b", smoke=True))
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        r.integers(0, model.cfg.vocab, (4, 16)).astype(np.int32))}
    outs = {}
    for mb in (1, 2):
        params = model.init_params(0, device="cpu")
        tcfg = ts.TrainConfig(learning_rate=1e-3, microbatch=mb)
        state = ts.make_train_state(model, params, tcfg)
        new_state, metrics = ts.build_train_step(model, tcfg)(state, batch)
        first = T.items(new_state["params"].tree())[0][1]
        outs[mb] = (float(metrics["loss"]),
                    torch.stack(first).detach().numpy().copy())
    assert abs(outs[1][0] - outs[2][0]) < 2e-3
    np.testing.assert_allclose(outs[1][1], outs[2][1], atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("arch,optimizer,mb", [
    ("yi-6b", "adamw", 2), ("yi-6b", "adafactor", 1),
    ("zamba2-2.7b", "adamw", 1)])
def test_train_step_matches_reference(arch, optimizer, mb):
    ref, params, port, _ = pair(arch, optimizer=optimizer)
    tcfg = dict(learning_rate=LR, microbatch=mb, warmup_steps=1)
    rstate = ref_ts.make_train_state(ref, params, ref_ts.TrainConfig(**tcfg))
    pstate = interop.train_state_from_reference(
        port.cfg, jax.tree_util.tree_map(np.asarray, rstate), "cpu")
    rb, pb = train_batches(port.cfg, B=4)
    rstate, rm = jax.jit(ref_ts.build_train_step(
        ref, ref_ts.TrainConfig(**tcfg)))(rstate, rb)
    pstate, pm = ts.build_train_step(port, ts.TrainConfig(**tcfg))(pstate, pb)
    for k in ("loss", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
    back = interop.train_state_to_reference(pstate)
    ptol = ADAM_TOL if optimizer == "adamw" else 1e-5
    for path, want in T.items(jax.tree_util.tree_map(np.asarray, rstate)):
        got = np.asarray(T.get(back, path))
        assert got.shape == want.shape, path
        tol = ptol if path[0] == "params" else \
            1e-5 * (float(np.abs(want).max()) or 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol,
                                   err_msg="/".join(path))


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "4",
            "--global-batch", "4", "--seq-len", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    losses = launch_train.main(argv)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert ckpt.latest_step(str(tmp_path)) == 4
    again = launch_train.main(argv[:6] + ["6"] + argv[7:])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out
    assert len(again) == 2 and all(np.isfinite(again))
    manifest = msgpack.unpackb(
        (tmp_path / "step_00000006" / "manifest.msgpack").read_bytes())
    paths = [e["path"] for e in manifest["entries"]]
    assert paths[0] == "opt/mu/dense/ln1" and paths[-1] == "step"
    assert "params/dense/wq" in paths and "opt/step" in paths


def test_train_cli_refuses_the_production_mesh():
    with pytest.raises(NotImplementedError, match="A5"):
        launch_train.main(["--arch", "yi-6b", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A5"):
        launch_train.main(["--arch", "yi-6b", "--smoke", "--multi-pod",
                           "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A5"):
        launch_train.main(["--arch", "yi-6b", "--smoke", "--compress-dcn",
                           "bf16", "--device", "cpu"])


def _train_golden_maker():
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "torch_golden"
    spec = importlib.util.spec_from_file_location(
        "make_train_golden", path / "make_train_golden.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    return maker


def _check_train_golden(maker, name):
    """The golden ``maker.GOLDENS[name]`` carries its maker's configuration
    and optimizers, and samples every leaf of the train state, of its shape,
    at the maker's indices (a parameter and its AdamW moments at the same
    ones)."""
    import json
    arch, optimizers, out = maker.GOLDENS[name]
    golden = json.loads(out.read_text())
    assert (golden["arch"], golden["n_layers"], golden["dtype"],
            golden["seq_len"], golden["global_batch"], golden["microbatch"],
            golden["n_steps"]) == (arch, maker.N_LAYERS, maker.DTYPE,
                                   maker.SEQ_LEN, maker.GLOBAL_BATCH,
                                   maker.MICROBATCH, maker.N_STEPS)
    assert [r["optimizer"] for r in golden["runs"]] == list(optimizers)
    for run in golden["runs"]:
        _, cfg = maker.configs(run["optimizer"], arch)
        params = T.map_leaves(lambda sd: torch.empty(sd[0], device="meta"),
                              Model(cfg).param_shapes())
        state = {"opt": opt_mod.make(run["optimizer"]).init(params),
                 "params": params, "step": torch.zeros(())}
        tokens = maker.data_mod.batch_for_step(
            maker.data_config(cfg.vocab), 0)[0, :4]
        leaves = [(maker.sample_key(p), "/".join(p), tuple(leaf.shape))
                  for p, leaf in maker.leaf_paths(state) if p[-1] != "step"]
        assert len(run["steps"]) == maker.N_STEPS
        for step in run["steps"]:
            assert np.isfinite(step["loss"]) and step["grad_norm"] > 0
            assert set(step["state"]) == {p for _, p, _ in leaves}
            for key, p, shape in leaves:
                rec = step["state"][p]
                assert tuple(rec["shape"]) == shape, p
                assert rec["idx"] == maker.sample_indices(
                    key, shape, tokens).tolist(), p
                if p.startswith("opt/mu/"):
                    assert rec["idx"] == step["state"][
                        "params/" + key]["idx"], p
                assert np.isfinite(rec["values"]).all(), p


def test_train_golden_matches_its_maker():
    """``tests/torch_golden/train_yi6b_l2.json`` (which ``chip_smoke.py``
    holds the card's train steps to) matches its maker
    (``_check_train_golden``).  (Re-deriving its values needs Yi-6B at full
    width: ``make_train_golden.py``.)"""
    maker = _train_golden_maker()
    assert maker.GOLDENS["yi6b"] == (maker.ARCH, maker.OPTIMIZERS, maker.OUT)
    _check_train_golden(maker, "yi6b")


def test_ssm_train_golden_matches_its_maker():
    """``tests/torch_golden/train_mamba2_l2.json`` (Mamba2-130M at full
    width, 2 layers: the card's float32 SSD kernels in a train step)
    matches its maker (``_check_train_golden``)."""
    _check_train_golden(_train_golden_maker(), "mamba2")
