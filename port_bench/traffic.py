"""The general generator of the traffic mixes in `traffic/<name>.json`.

A mix states what one request is, in words (`request`), and the material
that every request of the mix carries (`material`: `cohesion`, in the
configuration's stress unit, and `friction_angle_deg`).  One client sends
the requests in a closed loop, each when the last has finished, so every
request of a run is the same solve; `--seed` draws only which answer the
check compares besides the last (`harness.Sampler`).
"""
from __future__ import annotations

KEYS = ("cohesion", "friction_angle_deg")


def material(traffic: dict) -> dict:
    """The mix's material, each key of KEYS as a float; any other key is
    refused."""
    given = traffic["material"]
    if set(given) != set(KEYS):
        raise ValueError(f"a mix's material has the keys {list(KEYS)}; this one {sorted(given)}")
    return {k: float(given[k]) for k in KEYS}
