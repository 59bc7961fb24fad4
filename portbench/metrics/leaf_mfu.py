"""The whole batched leaf's share of the chip's peak, in %: the least time
of a leaf's work at the cell's shapes over its device time (the window's
graph replays, CUDA events, over its batched leaves). The work, each part
the larger of its operations at 67 TFLOP/s and its bytes at 3.35 TB/s:
the value-and-grad (the whitened FN kernel's count, or the four K1
launches' where autograd or the raw target runs them), the two whitening
GEMMs where whitened, the metric's product (dense: C dim^2; one matrix per
rung under tempering; a diagonal's is the commit's), and the commit with
the chains alive on average. The count is the work whatever implements
it, so it bounds a kernel's gain after any fusion. Moves ``draws_per_s``."""

from portbench.core import work


def leaf_least_s(s: dict) -> float:
    if s["route"] == "kernel":
        vg = work.least_s(*work.centered_vg(s["c"], s["n"], s["b"], s["dim"], s["d"]))
    else:
        vg = sum(work.least_s(*p) for p in work.k1_launches(s["c"], s["d"], s["b"], s["n"]))
    gemms = 2 * work.least_s(*work.dense_product(s["c"], s["dim"])) if s["whitened"] else 0.0
    metric = (work.least_s(*work.dense_product(s["c"], s["dim"], s["rungs"]))
              if s["metric"] != "diag" else 0.0)
    commit = work.least_s(0.0, work.commit_bytes(s["c"], s["dim"], s["alive"], s["metric"]))
    return vg + gemms + metric + commit


def read(r):
    if not r.get("busy_s") or not r.get("leaves"):
        return None
    return 100.0 * leaf_least_s(r["shapes"]) * r["leaves"] / r["busy_s"]
