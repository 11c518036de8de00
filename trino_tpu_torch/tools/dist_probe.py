"""Which process group can gather a resident build between two processes
that share one card.

``python -m trino_tpu_torch.tools.dist_probe [--device cuda]`` starts two
ranks (this module again, one process each, an ephemeral port) for each
case and prints one JSON line per case, then a summary line.  Each rank
gathers 1,500,000 int64 rows (SF 1's orders keys) with ``all_gather``:

- ``gloo``: ``plan_compiler.init_distributed`` (gloo), the device
  tensors handed to ``all_gather`` as they are;
- ``gloo-through-host``: the same group, the rows copied to host tensors
  before the gather and back onto the device after it;
- ``nccl-one-card``: an NCCL group whose two ranks are both on
  ``cuda:0``.

Each case reports ``ok``, the error text of a rank that failed, and the
gather's ms (median of five, after one warm-up) where it worked.  A case
whose ranks do not end within 90 s is killed and reported as ``hung``.
Runs on the card (``--device cpu`` is a rehearsal of the two gloo
cases).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

CASES = ("gloo", "gloo-through-host", "nccl-one-card")
ROWS = 1_500_000
TIMEOUT_S = 90.0


def _rank(case: str, rank: int, port: int, device: str) -> None:
    import torch
    import torch.distributed as dist

    from ..execution import plan_compiler as PC

    dev = torch.device(device)
    if case == "nccl-one-card":
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
    else:
        PC.init_distributed(f"127.0.0.1:{port}", num_processes=2,
                            process_id=rank)
    local = torch.arange(ROWS, dtype=torch.int64, device=dev) + rank * ROWS
    want = torch.arange(2 * ROWS, dtype=torch.int64, device=dev)

    def gather():
        src = local.cpu() if case == "gloo-through-host" else local
        parts = [torch.empty_like(src) for _ in range(2)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(dev)

    out = {"case": case, "rank": rank}
    try:
        got = gather()
        out["ok"] = bool(torch.equal(got, want))
        out["device"] = str(got.device)
        times = []
        for _ in range(5):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            gather()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = sorted(times)[2]
    except Exception as e:  # noqa: BLE001 — the finding is the error
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:500]
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_case(case: str, device: str) -> dict:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trino_tpu_torch.tools.dist_probe", "--rank",
         str(r), "--port", str(port), "--case", case, "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs, hung = [], False
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            hung = True
            outs.append(("", ""))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    ranks = []
    for p, (so, se) in zip(procs, outs):
        line = [ln for ln in so.splitlines() if ln.startswith("{")]
        ranks.append(json.loads(line[-1]) if line else {
            "ok": False, "error": f"rc={p.returncode}: {se.strip()[-500:]}"})
    return {"case": case, "rows_per_rank": ROWS, "device": device,
           "hung": hung, "ok": not hung and all(r.get("ok") for r in ranks),
           "errors": [r["error"] for r in ranks if "error" in r],
           "ms": [r.get("ms") for r in ranks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    # a rank of a case (the probe starts these itself)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--case", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.case, args.rank, args.port, args.device)
        return 0
    cases = CASES if args.device != "cpu" else CASES[:2]
    recs = [run_case(c, args.device) for c in cases]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    print(json.dumps({c["case"]: ("hung" if c["hung"] else c["ok"])
                      for c in recs}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
