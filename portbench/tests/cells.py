"""Small cells for the CPU tests: a checkout of their own under a test's
temporary directory holding a ``BENCHMARK.json``, data files and limits,
with the harness's metric readers linked in, so that a cell is added by
files and entries alone."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]
REPO = HARNESS.parent

TINY_MODEL = {
    "architecture": "AASIST", "nb_samp": 16000, "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 8], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0]}

LENGTHS = {"median_s": 0.8, "sigma": 0.45, "min_s": 0.5, "max_s": 1.6}
GAIN = {"min": 0.01, "max": 0.3}
OPTIM = {"optimizer": "adam", "amsgrad": "False", "base_lr": 0.0001,
         "lr_min": 0.000005, "betas": [0.9, 0.999],
         "weight_decay": 0.0001, "scheduler": "cosine"}


def config(res2net: bool = False, dtype: str = "float32") -> dict:
    mc = copy.deepcopy(TINY_MODEL)
    if res2net:
        mc.update(res2net_width=4, res2net_scale=2)
    return {"source": "test", "reduced": [], "reference": "aasist",
            "model_config": mc,
            "serve": {"weights": "seed", "dtype": dtype, "batch_size": 4,
                      "window": 16000},
            "train": {"weights": "seed", "dtype": "float32",
                      "batch_size": 4, "num_epochs": 100, "loss": "CCE",
                      "optim_config": OPTIM},
            "flops": {}}


TRAFFIC = {
    "shards": {"kind": "score", "lengths": LENGTHS, "gain": GAIN,
               "pool": 12, "request_sizes": [12],
               "arrivals": {"loop": "closed"}, "check_sample": 64},
    "requests": {"kind": "score", "lengths": LENGTHS, "gain": GAIN,
                 "pool": 16, "request_sizes": [1, 2, 4],
                 "arrivals": {"loop": "open", "rate_per_s": 50.0,
                              "gaps": "fixed"}, "check_sample": 64},
    "train": {"kind": "train", "lengths": LENGTHS, "gain": GAIN,
              "corpus": {"utterances": 40, "bonafide_share": 0.25},
              "crop": 16000},
}

# the repo's cell that each test mix stands for
ANALOG = {"shards": "aasist-score-b128", "requests": "aasist-verify-small",
          "train": "aasist-train-b24"}

SCORE_LIMITS = {"gap_max": {"limit": 1e-3}, "gap_mean": {"limit": 1e-4}}
TRAIN_LIMITS = {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-4},
                "update_gap": {"limit": 1e-2}}


def make_checkout(root: Path, cells) -> Path:
    """A checkout at ``root`` with one workload per entry of ``cells``:
    (name, config name, config dict, traffic name, limits)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    h = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (h / sub).mkdir(parents=True, exist_ok=True)
    (h / "metrics").symlink_to(HARNESS / "metrics")
    bench["configs"], bench["workloads"] = [], []
    for name, cname, conf, traffic, limits in cells:
        (h / "configs" / f"{cname}.json").write_text(json.dumps(conf))
        (h / "traffic" / f"{traffic}.json").write_text(
            json.dumps(TRAFFIC[traffic]))
        (h / "limits" / f"{name}.json").write_text(json.dumps(limits))
        if cname not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(
                {"name": cname, "source": "test",
                 "file": f"portbench/configs/{cname}.json", "reduced": [],
                 "why": "test"})
        bench["workloads"].append({"name": name, "config": cname,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    # each metric goes to the test cells whose mix is that of a cell of
    # the repo's benchmark that reports it
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in bench["workloads"]
                              if ANALOG[w["traffic"]] in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
