"""Write the JAX reference runner's output on the two k=8 campaigns that
``chip_smoke.py``'s ``campaign`` phase runs through the port's CLI on the
card (the card has no JAX).

Run from the repository root on a machine with JAX (CPU is enough; a few
minutes, most of it ``fig12``'s slotted engine):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_sweep_golden.py

For each campaign of :data:`CAMPAIGNS` it runs ``python -m repro.sweep run
--preset NAME --k 8 --seeds ... --out DIR`` on one CPU device and writes,
into ``tests/torch_golden/sweep_k8.json``: the CLI arguments, the
campaign's JSON spec, the ``results.jsonl`` text and its sha256, and the
trace's spans after ``strip_timing`` (the slot-step ``impl`` of loop
dispatches is the reference's ``"lax"``; the port records ``"cuda"`` on a
card):

* ``table2 --k 8 --seeds 0,1``: 28 points on the fast engine (the
  permutation and the all-to-all; ``segmented_cummax`` and, for
  switch_pkt_ar, ``jsq_scan``);
* ``fig12 --k 8 --seeds 0``: 5 points of SACK loss recovery on the slotted
  engine (``jsq_pick``, ``enqueue``, ``agg_jsq_enqueue`` and the SACK pair).

``tests/test_torch_sweep.py`` checks the file against the port's plans.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

OUT = Path(__file__).resolve().parent / "sweep_k8.json"
ROOT = Path(__file__).resolve().parents[2]
CAMPAIGNS = {"table2": ((8,), (0, 1)), "fig12": ((8,), (0,))}


def argv(name, trees, seeds, out):
    return ["run", "--preset", name, "--k", ",".join(map(str, trees)),
            "--seeds", ",".join(map(str, seeds)), "--out", str(out),
            "--no-compile-cache", "--quiet"]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import hashlib
    from repro.obs import load_trace, strip_timing
    from repro.sweep import preset

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # One device: the card runs one, and the spans count devices.
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    golden = {"campaigns": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (trees, seeds) in CAMPAIGNS.items():
            out = Path(tmp) / name
            args = argv(name, trees, seeds, "OUT")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "repro.sweep",
                            *argv(name, trees, seeds, out)], env=env,
                           check=True)
            text = (out / "results.jsonl").read_text()
            spans = [strip_timing(s)
                     for s in load_trace(out / "trace.jsonl")]
            golden["campaigns"][name] = {
                "argv": args, "argv_k": list(trees),
                "argv_seeds": list(seeds),
                "spec": preset(name, trees=trees, seeds=seeds).to_dict(),
                "results": text,
                "sha256": hashlib.sha256(text.encode()).hexdigest(),
                "trace": spans,
            }
            print(f"{name}: {text.count(chr(10))} records, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    OUT.write_text(json.dumps(golden, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
