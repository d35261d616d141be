"""Write the JAX reference's first two train steps of a model at full
width, cut to 2 layers, in float32, which ``chip_smoke.py`` (phase
``train_golden``) holds the port's train step to on the card (which has no
JAX): Yi-6B (``yi6b``) once with the config's AdamW and once with its
optimizer replaced by Adafactor, and Mamba2-130M (``mamba2``, 2 of its 24
layers: the SSD scan's forward and backward kernels in float32) with its
AdamW.

Run from the repository root on a machine with JAX (CPU is enough; Yi-6B
~1 min and ~11 GB of memory at the AdamW step, Mamba2-130M ~20 s), naming
the goldens to write (default: all):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_train_golden.py [yi6b] [mamba2]

Parameters are ``repro_torch.interop.numpy_reference_params(cfg, 0)`` (as in
``make_serve_golden.py``: 0.93 B float32 numbers).  The batches are
``repro.train.data.batch_for_step`` of ``DataConfig(vocab, SEQ_LEN,
GLOBAL_BATCH)`` for steps 0 and 1; the step is ``build_train_step`` under
``jax.jit`` with ``TrainConfig(microbatch=MICROBATCH)`` (learning rate
3e-4, 100 warmup steps, clip 1.0).  For each step the file keeps the loss
and the gradient norm; after each step, for every leaf of the train state
(``params``, ``opt``), the values at ``N_IDX`` flat indices drawn from
``default_rng([IDX_SEED, crc32(key)])`` (and, for ``params/embed`` and its
moments, the first 16 columns of the rows of the first 4 tokens, which
the gradient reaches).  ``key`` is the leaf's path below ``params``,
``opt/mu`` or ``opt/nu``, so a parameter and its AdamW moments are sampled
at the same indices: the card's check reads a parameter's first moment to
find where the update's sign is not determined.  It writes
``tests/torch_golden/train_yi6b_l2.json`` and ``train_mamba2_l2.json``.
"""
import dataclasses
import json
import sys
import time
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as ref_config
from repro.models.registry import Model
from repro.train import data as data_mod
from repro.train import train_step as ts

from repro_torch.configs import get_config
from repro_torch.interop import numpy_reference_params

HERE = Path(__file__).resolve().parent
OUT = HERE / "train_yi6b_l2.json"
ARCH, N_LAYERS, DTYPE = "yi-6b", 2, "float32"
PARAM_SEED, IDX_SEED = 0, 5
SEQ_LEN, GLOBAL_BATCH, MICROBATCH, N_STEPS = 128, 4, 2, 2
N_IDX = 64
OPTIMIZERS = ("adamw", "adafactor")
# name: (arch, optimizers, output file)
GOLDENS = {"yi6b": (ARCH, OPTIMIZERS, OUT),
           "mamba2": ("mamba2-130m", ("adamw",),
                      HERE / "train_mamba2_l2.json")}


def configs(optimizer, arch=ARCH):
    """(reference config, port config) of the golden's model."""
    cut = dict(n_layers=N_LAYERS, dtype=DTYPE, optimizer=optimizer)
    return (dataclasses.replace(ref_config(arch), **cut),
            dataclasses.replace(get_config(arch), **cut))


def data_config(vocab):
    return data_mod.DataConfig(vocab=vocab, seq_len=SEQ_LEN,
                               global_batch=GLOBAL_BATCH)


def leaf_paths(tree, prefix=()):
    """(path, array) of every leaf in flatten order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def sample_key(path):
    """The leaf's path below ``params``, ``opt/mu`` or ``opt/nu`` (else its
    whole path), joined by '/'."""
    for head in (("params",), ("opt", "mu"), ("opt", "nu")):
        if tuple(path[:len(head)]) == head:
            return "/".join(path[len(head):])
    return "/".join(path)


def sample_indices(key, shape, tokens):
    """Flat indices of the train-state leaf of ``sample_key`` ``key``:
    N_IDX drawn from ``default_rng([IDX_SEED, crc32(key)])``, and for an
    embedding-shaped leaf (vocab, d_model) the first 16 columns of the rows
    of ``tokens``."""
    size = int(np.prod(shape))
    idx = np.random.default_rng([IDX_SEED, zlib.crc32(key.encode())]).choice(
        size, min(N_IDX, size), replace=False)
    if len(shape) == 2 and shape[0] > shape[1]:       # embed and its moments
        rows = np.asarray(tokens, np.int64)[:, None] * shape[1]
        idx = np.concatenate([idx, (rows + np.arange(16)).reshape(-1)])
    return np.sort(idx).astype(np.int64)


def snapshot(state, tokens):
    out = {}
    for path, leaf in leaf_paths(state):
        if path[-1] == "step":
            continue
        a = np.asarray(leaf)
        idx = sample_indices(sample_key(path), a.shape, tokens)
        out["/".join(path)] = {"shape": list(a.shape), "idx": idx.tolist(),
                               "values": a.reshape(-1)[idx].tolist()}
    return out


def run(optimizer, arch=ARCH):
    rcfg, pcfg = configs(optimizer, arch)
    model = Model(rcfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, numpy_reference_params(pcfg, PARAM_SEED))
    tcfg = ts.TrainConfig(microbatch=MICROBATCH)
    state = ts.make_train_state(model, params, tcfg)
    del params
    step_fn = jax.jit(ts.build_train_step(model, tcfg), donate_argnums=(0,))
    dcfg = data_config(rcfg.vocab)
    tokens = data_mod.batch_for_step(dcfg, 0)[0, :4]
    steps = []
    for s in range(N_STEPS):
        batch = {"tokens": jnp.asarray(data_mod.batch_for_step(dcfg, s))}
        state, m = step_fn(state, batch)
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "state": snapshot(state, tokens)})
        print(f"{optimizer} step {s}: loss {steps[-1]['loss']:.6f} "
              f"grad_norm {steps[-1]['grad_norm']:.6f}", flush=True)
    return {"optimizer": optimizer, "steps": steps,
            "learning_rate": tcfg.learning_rate,
            "warmup_steps": tcfg.warmup_steps}


def main(names):
    for name in names or GOLDENS:
        arch, optimizers, out = GOLDENS[name]
        t0 = time.time()
        runs = []
        for optimizer in optimizers:
            runs.append(run(optimizer, arch))
            jax.clear_caches()
        rec = {"arch": arch, "n_layers": N_LAYERS, "dtype": DTYPE,
               "param_seed": PARAM_SEED, "seq_len": SEQ_LEN,
               "global_batch": GLOBAL_BATCH, "microbatch": MICROBATCH,
               "n_steps": N_STEPS, "runs": runs,
               "made_by": "tests/torch_golden/make_train_golden.py (CPU JAX)"}
        out.write_text(json.dumps(rec, separators=(",", ":")) + "\n")
        print(f"wrote {out} ({out.stat().st_size:,} bytes) in "
              f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
