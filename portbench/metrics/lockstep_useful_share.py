"""Share of the batched leapfrog steps that some chain's own tree needed:
the chains' leaves (``num_leapfrog`` summed) over chains x batched leaves,
in %. Moves ``draws_per_s``."""


def read(r):
    if not r.get("leaves"):
        return None
    return 100.0 * r["chain_leaves"] / (r["n_chains"] * r["leaves"])
