#!/usr/bin/env python3
"""Time this checkout's host-bound windows against another checkout's, in
turns, on one card: the contiguous dispatch-mode window of int8 GPT-2
small (``chip_smoke.dispatch_modes``: eager, captured, captured with
lookahead) and bf16 GPT-2 small's training step at dropout 0
(``chip_smoke.train``).

    python3 tools/host_path_ab.py --other DIR [--rounds 2] [--out FILE]

DIR is another checkout (e.g. the parent commit unpacked with ``git
archive`` under ``build/parent``). Each run is its own process started in
its checkout's root, so it imports that checkout's ``mxnet_tpu_torch`` and
``chip_smoke`` (and builds that checkout's kernels there); runs go other,
this, this, other, ... Prints one summary line per run; ``--out`` keeps
every JSON line the runs printed, tagged with tree and round.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import inspect, sys, types
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
args = types.SimpleNamespace(seed=0)
with torch.no_grad():
    net = GPTModel(GPT2_SMALL, device="cuda").init_weights(0)
    quantize_net(net, fused_decode=True)
cs.dispatch_modes(torch, args, net, "contiguous")
del net
torch.cuda.empty_cache()
if "dropout" in inspect.signature(cs.train).parameters:
    cs.train(torch, args, 0.0)
else:
    cs.train(torch, args)
"""


def run(tree):
    """One run in ``tree``: its JSON lines."""
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                         text=True, timeout=1800)
    if out.returncode != 0:
        sys.exit(f"run in {tree} failed ({out.returncode}):\n{out.stderr[-4000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]


def summary(lines):
    s = {}
    for d in lines:
        if "dispatch_modes_contiguous" in d:
            for mode, r in d["dispatch_modes_contiguous"]["modes"].items():
                s[mode] = {"tokens_per_s": r["tokens_per_s"],
                           "ms_per_substep": r["ms_per_substep"],
                           "idle_share": r["idle_share"]}
        elif "train" in d:
            s["train_ms_per_step"] = d["train"]["ms_per_step"]
        elif isinstance(d.get("train_profiled_window"), dict):
            w = d["train_profiled_window"]
            s["train_idle_share"] = w["idle_share"]
            s["train_busy_ms_per_step"] = w["device_busy_ms"] / w["steps"]
    return s


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="file for every JSON line of every run")
    a = ap.parse_args()
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"other": os.path.abspath(a.other), "this": this}
    sink = open(a.out, "w") if a.out else None
    try:
        for r in range(a.rounds):
            for name in (("other", "this") if r % 2 == 0 else ("this", "other")):
                lines = run(trees[name])
                if sink:
                    for d in lines:
                        sink.write(json.dumps({"tree": name, "round": r, **d}) + "\n")
                print(json.dumps({"tree": name, "round": r, **summary(lines)}), flush=True)
    finally:
        if sink:
            sink.close()


if __name__ == "__main__":
    main()
