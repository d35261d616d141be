"""Write the JAX reference's greedy decode of Yi-6B at full width, cut to 2
layers, in float32, which ``chip_smoke.py`` holds the port to on the card
(which has no JAX).

Run from the repository root on a machine with JAX (CPU is enough, ~1 min,
~8 GB of memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_serve_golden.py

Parameters are ``repro_torch.interop.numpy_reference_params(cfg, 0)``: numpy
normals (each leaf in blocks, a stream ``default_rng([0, leaf, block])``
each) times ``fan_in ** -0.5`` and ones for 1-D leaves, as ``repro.models.transformer.init_params`` draws its leaves (3.5 GB
of float32).  Prompts of 37 and 256 tokens come from ``default_rng(1)``.
Each prompt is decoded alone (batch 1) through the reference's
``serve_step.build_serve_fns`` for ``N_NEW`` greedy steps.  For each step
the file keeps the token, the top-16 logits with their ids, the top-2
margin, and the logits at 512 fixed vocabulary ids (``default_rng(2)``);
no full logits rows.  It writes ``tests/torch_golden/serve_yi6b_l2.json``.
"""
import dataclasses
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as ref_config
from repro.models.registry import Model
from repro.serve import serve_step

from repro_torch.configs import get_config
from repro_torch.interop import numpy_reference_params

OUT = Path(__file__).resolve().parent / "serve_yi6b_l2.json"
ARCH, N_LAYERS, DTYPE = "yi-6b", 2, "float32"
PARAM_SEED, PROMPT_SEED, FIXED_SEED = 0, 1, 2
PROMPT_LENS = (37, 256)
N_NEW, N_TOP, N_FIXED = 4, 16, 512


def configs():
    """(reference config, port config) of the golden's model."""
    cut = dict(n_layers=N_LAYERS, dtype=DTYPE)
    return (dataclasses.replace(ref_config(ARCH), **cut),
            dataclasses.replace(get_config(ARCH), **cut))


def prompts(vocab):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def fixed_ids(vocab):
    return np.sort(np.random.default_rng(FIXED_SEED).choice(
        vocab, N_FIXED, replace=False)).astype(np.int64)


def step_record(logits, ids):
    """The golden's record of one step's (vocab,) float32 logits."""
    top = np.argsort(-logits, kind="stable")[:N_TOP]
    return {"token": int(top[0]), "top_ids": top.tolist(),
            "top_logits": logits[top].tolist(),
            "margin": float(logits[top[0]] - logits[top[1]]),
            "fixed_logits": logits[ids].tolist()}


def main():
    t0 = time.time()
    rcfg, pcfg = configs()
    model = Model(rcfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, numpy_reference_params(pcfg, PARAM_SEED))
    prefill, decode = serve_step.build_serve_fns(model)
    ids = fixed_ids(rcfg.vocab)
    runs = []
    for prompt in prompts(rcfg.vocab):
        S = len(prompt)
        cache = serve_step.zero_cache(model, 1, S + N_NEW)
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompt[None])},
                                cache)
        steps = []
        for i in range(N_NEW):
            if i:
                tok = jnp.asarray([[steps[-1]["token"]]], jnp.int32)
                logits, cache = decode(params, tok, cache, S + i - 1)
            steps.append(step_record(np.asarray(logits[0, -1], np.float32),
                                     ids))
        tokens = np.asarray(serve_step.greedy_decode(
            model, params, jnp.asarray(prompt[None]), N_NEW))[0].tolist()
        assert tokens == [s["token"] for s in steps], tokens
        runs.append({"prompt": prompt.tolist(), "tokens": tokens,
                     "steps": steps})
        print(f"prompt {S}: tokens {tokens}, margins "
              f"{[round(s['margin'], 5) for s in steps]}", flush=True)
    OUT.write_text(json.dumps({
        "arch": ARCH, "n_layers": N_LAYERS, "dtype": DTYPE,
        "param_seed": PARAM_SEED, "prompt_seed": PROMPT_SEED,
        "n_new": N_NEW, "fixed_ids": ids.tolist(), "runs": runs,
        "jax": jax.__version__}, indent=None))
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
