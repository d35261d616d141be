"""Write the JAX reference's greedy decode of the two SSM-family models,
which ``chip_smoke.py`` holds the port to on the card (which has no JAX):
Mamba2-130M at full size and Zamba2-2.7B at full width cut to 6 layers
(one application of the shared block), both in float32.

Run from the repository root on a machine with JAX (CPU is enough, ~2 min,
~6 GB of memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_ssm_golden.py

Parameters are ``repro_torch.interop.numpy_reference_params(cfg, 0)``: numpy
draws (each leaf in blocks, a stream ``default_rng([0, leaf, block])``
each) by the SSM init rule of ``repro.models.mamba2``
(normals times ``fan_in ** -0.5`` where the last axis exceeds 8, else 0.1;
``A_log = 0``, ``dt_bias = -2``; 2.0 GB of float32 for the Zamba2 cut).
Prompts, steps and records are those of ``make_serve_golden.py``: prompts
of 37 and 256 tokens from ``default_rng(1)``, each decoded alone through
the reference's ``serve_step.build_serve_fns`` for 4 greedy steps; each
step keeps the token, the top-16 logits with their ids, the top-2 margin
and the logits at 512 fixed vocabulary ids (``default_rng(2)``).  It writes
``tests/torch_golden/serve_ssm.json``: one record a model, in the format of
``serve_yi6b_l2.json``.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_serve_golden import (N_NEW, PARAM_SEED, PROMPT_SEED,  # noqa: E402
                               fixed_ids, prompts, step_record)

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models.registry import Model  # noqa: E402
from repro.serve import serve_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import numpy_reference_params  # noqa: E402

OUT = Path(__file__).resolve().parent / "serve_ssm.json"
DTYPE = "float32"
# (arch, layers): Mamba2-130M whole, Zamba2-2.7B cut to one application of
# its shared block (shared_attn_every = 6).
MODELS = (("mamba2-130m", 24), ("zamba2-2.7b", 6))


def configs(arch, n_layers):
    """(reference config, port config) of one golden model."""
    cut = dict(n_layers=n_layers, dtype=DTYPE)
    return (dataclasses.replace(ref_config(arch), **cut),
            dataclasses.replace(get_config(arch), **cut))


def golden_model(arch, n_layers):
    rcfg, pcfg = configs(arch, n_layers)
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
        print(f"{arch} prompt {S}: tokens {tokens}, margins "
              f"{[round(s['margin'], 5) for s in steps]}", flush=True)
    return {"arch": arch, "n_layers": n_layers, "dtype": DTYPE,
            "param_seed": PARAM_SEED, "prompt_seed": PROMPT_SEED,
            "n_new": N_NEW, "fixed_ids": ids.tolist(), "runs": runs}


def main():
    t0 = time.time()
    models = [golden_model(arch, n) for arch, n in MODELS]
    OUT.write_text(json.dumps({"models": models, "jax": jax.__version__},
                              indent=None))
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
