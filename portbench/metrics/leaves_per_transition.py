"""Batched leapfrog steps per transition in the window (the tree's
``lockstep_leaves`` over the transitions): the steps every chain pays in
lockstep. Moves ``draws_per_s``."""


def read(r):
    if not r.get("transitions"):
        return None
    return r["leaves"] / r["transitions"]
