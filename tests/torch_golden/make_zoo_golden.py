"""Write the JAX reference's greedy decode of the MoE, MLA, VLM and enc-dec
models at full width, in float32, which ``chip_smoke.py`` holds the port to
on the card (which has no JAX):

* ``serve_moe_l2.json``: Qwen3-MoE-30B-A3B cut to 2 layers (128 experts,
  top 8; the reference's one-device dense oracle);
* ``serve_mla_l1.json``: DeepSeek-V3 cut to ``n_layers = n_dense_layers =
  1`` (MLA with the dense MLP);
* ``serve_vlm_l2.json``: LLaVA-NeXT-34B cut to 2 layers, with
  ``N_VISION`` vision embeds before each prompt;
* ``serve_encdec.json``: Whisper-small whole, with 1,500 frames.

Run from the repository root on a machine with JAX (CPU is enough, ~5 min,
~20 GB of memory at its peak, DeepSeek-V3's cut):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_zoo_golden.py [name ...]

Parameters are ``repro_torch.interop.numpy_reference_params(cfg, 0)``
(each leaf's normals in blocks of independent numpy streams, drawn in
parallel), carried into JAX one leaf at a time.  Prompts, steps and records are those
of ``make_serve_golden.py`` (prompts of 37 and 256 tokens from
``default_rng(1)``, each decoded alone for 4 greedy steps; each step keeps
the token, the top-16 logits with their ids, the top-2 margin and the
logits at 512 fixed ids; a MoE run also its ``route_gap``, the smallest
gap between a token's 8th and 9th router logits in any layer).  The
frontend input (``front``: the batch key,
its positions, its width and its seed) is
``default_rng(seed).standard_normal((1, n, width), dtype=float32)``, the
same for both prompts.
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

HERE = Path(__file__).resolve().parent
DTYPE = "float32"
FRONT_SEED = 3
N_VISION = 2880
# name: (arch, config fields cut, frontend batch key or None)
GOLDENS = {
    "serve_moe_l2.json": ("qwen3-moe-30b-a3b", {"n_layers": 2}, None),
    "serve_mla_l1.json": ("deepseek-v3-671b",
                          {"n_layers": 1, "n_dense_layers": 1}, None),
    "serve_vlm_l2.json": ("llava-next-34b", {"n_layers": 2},
                          "vision_embeds"),
    "serve_encdec.json": ("whisper-small", {}, "frames"),
}


def configs(arch, cut):
    """(reference config, port config) of one golden model."""
    cut = dict(cut, dtype=DTYPE)
    return (dataclasses.replace(ref_config(arch), **cut),
            dataclasses.replace(get_config(arch), **cut))


def front_spec(cfg, key):
    """The golden's frontend input record, or None."""
    if key is None:
        return None
    n = N_VISION if key == "vision_embeds" else cfg.n_frontend_tokens
    return {"key": key, "n": n, "width": cfg.frontend_dim or cfg.d_model,
            "seed": FRONT_SEED}


def front_input(spec):
    return np.random.default_rng(spec["seed"]).standard_normal(
        (1, spec["n"], spec["width"]), dtype=np.float32)


def jax_params(cfg):
    """``numpy_reference_params(cfg, PARAM_SEED)`` as jax arrays, each
    numpy leaf dropped once carried (the peak holds one copy and a leaf)."""
    tree = numpy_reference_params(cfg, PARAM_SEED)

    def carry(node):
        for k in list(node):
            if isinstance(node[k], dict):
                carry(node[k])
            else:
                node[k] = jnp.asarray(node.pop(k))
        return node
    return carry(tree)


def record_route_gaps(gaps):
    """Route the reference's MoE layers through ``_route`` as it is, also
    appending the smallest gap between a token's k-th and (k+1)-th router
    logits to ``gaps`` (how far the card's float32 sums may move a logit
    before an expert choice flips)."""
    from repro.models import moe as ref_moe
    real = ref_moe._route

    def recording(x2d, router, k):
        top = jax.lax.top_k(x2d.astype(jnp.float32) @ router, k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(np.min(g))),
                           top[:, k - 1] - top[:, k])
        return real(x2d, router, k)
    ref_moe._route = recording


def golden(arch, cut, key):
    t0 = time.time()
    rcfg, pcfg = configs(arch, cut)
    gaps = []
    if rcfg.n_experts:
        record_route_gaps(gaps)
    model = Model(rcfg)
    params = jax_params(pcfg)
    prefill, decode = serve_step.build_serve_fns(model)
    ids = fixed_ids(rcfg.vocab)
    spec = front_spec(rcfg, key)
    extra = None if spec is None else {key: jnp.asarray(front_input(spec))}
    n_front = spec["n"] if key == "vision_embeds" else 0
    runs = []
    for prompt in prompts(rcfg.vocab):
        S = len(prompt)
        cache = serve_step.zero_cache(model, 1, S + n_front + N_NEW)
        batch = {"tokens": jnp.asarray(prompt[None]), **(extra or {})}
        logits, cache = prefill(params, batch, cache)
        steps = []
        for i in range(N_NEW):
            if i:
                tok = jnp.asarray([[steps[-1]["token"]]], jnp.int32)
                logits, cache = decode(params, tok, cache,
                                       S + n_front + i - 1)
            steps.append(step_record(np.asarray(logits[0, -1], np.float32),
                                     ids))
        tokens = [s["token"] for s in steps]
        jax.effects_barrier()
        runs.append({"prompt": prompt.tolist(), "tokens": tokens,
                     "steps": steps,
                     "route_gap": min(gaps) if gaps else None})
        gaps.clear()
        print(f"{arch} prompt {S}: tokens {tokens}, margins "
              f"{[round(s['margin'], 5) for s in steps]}, smallest router "
              f"logit gap {runs[-1]['route_gap']} ({time.time() - t0:.0f} s)",
              flush=True)
    return {"arch": arch, "n_layers": rcfg.n_layers, "cut": cut,
            "dtype": DTYPE, "param_seed": PARAM_SEED,
            "prompt_seed": PROMPT_SEED, "n_new": N_NEW, "front": spec,
            "fixed_ids": ids.tolist(), "runs": runs,
            "jax": jax.__version__}


def main(names):
    for name in names or GOLDENS:
        t0 = time.time()
        rec = golden(*GOLDENS[name])
        (HERE / name).write_text(json.dumps(rec, indent=None))
        print(f"wrote {HERE / name} in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
