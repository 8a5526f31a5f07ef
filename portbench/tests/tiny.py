"""Small sizes of the cells' files for the CPU tests: the configurations
cut to 2 layers of width 128 (float32 unless asked), the mixes to prompts
of 64-256 tokens and 2-8 new ones."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 40 + 17


def config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    m = cfg["model"]
    m.update(n_layers=2, d_model=128, n_heads=4, head_dim=32, d_ff=256,
             vocab=512, dtype=dtype,
             n_kv_heads=2 if m["family"] == "dense" else 4)
    if m["family"] == "moe":
        m.update(n_experts=8, top_k=2, d_expert=64, moe_group_size=64)
        cfg["prompt_multiple"] = 64
    else:
        cfg["prompt_multiple"] = 32
    return cfg


def mix(name: str) -> dict:
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                   .read_text())
    t.update(prompt_tokens={"dist": "log_uniform", "low": 64, "high": 256},
             new_tokens={"dist": "log_uniform", "low": 2, "high": 8},
             max_len=272, block=8, pair_stride=3, swap=2)
    return t


def cell_files(workload: str, dtype: str = "float32"):
    w = {c["name"]: c for c in BENCH["workloads"]}[workload]
    return config(w["config"], dtype), mix(w["traffic"])


def run(workload: str, requests: int = 24, trace: bool = False,
        dtype: str = "float32", seed: int = SEED, limit: float = None,
        **kw) -> dict:
    """One run of ``workload`` on the CPU at the small sizes, serving
    ``requests`` requests (a fixed amount of work, whatever the load on
    the machine); a traced run profiles the first second. ``limit``, where
    given, replaces the configuration's limit of the mean logit gap."""
    import time
    from portbench import cell
    cfg, t = cell_files(workload, dtype)
    if limit is not None:
        cfg["correct"]["logit_gap_mean_limit"] = limit
    return cell.run_cell(BENCH, workload, seed, 0.0, trace, device="cpu",
                         t0=time.perf_counter(), config=cfg, traffic=t,
                         trace_seconds=1.0, requests=requests, **kw)
