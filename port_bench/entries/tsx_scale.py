"""The TSX tunnel at scale: `build_df32(TsxTunnelConfig.fast_scale(L,
...))` of the port, and its `run()`, one whole excavation, as a request.

`split` gives the check the port's state before a request's last load
trip: the solver built anew to stop one trip short, then resumed from that
state through `run(resume=carry)` to the end of the schedule."""
from __future__ import annotations

import math
import time

import numpy as np
import torch


class Solver:
    def __init__(self, config: dict, material: dict, root, device: torch.device, **kw):
        from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
        from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig

        self.cfg = TsxTunnelConfig.fast_scale(
            int(config["refine_levels"]), young=float(config["young"]),
            poisson=float(config["poisson"]), init_stress=tuple(config["init_stress"]),
            d_zeta=1.0 / int(config["load_steps"]), cohesion=float(material["cohesion"]),
            friction_angle=math.radians(float(material["friction_angle_deg"])),
            **config["preset"], **kw)
        t0 = time.perf_counter()
        self._run, mesh = tsx.build_df32(self.cfg, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_s = time.perf_counter() - t0
        self.layout = (np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems))

    def request(self, resume=None):
        return self._run(resume=resume)

    def counts(self, raw) -> dict:
        return {"cg": int(raw.n_cg_total), "newton": int(raw.n_newton_total),
                "steps": int(raw.n_steps), "plastic": int(raw.n_plastic), "zeta": float(raw.zeta)}

    def answer(self, raw) -> dict:
        host = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
        return {"u": host(raw.u).reshape(-1, 2), "ep": host(raw.ep), "zeta": float(raw.zeta),
                "n_steps": int(raw.n_steps), "zeta_hist": host(raw.zeta_hist)[:int(raw.n_steps)],
                "trips": len(raw.newton_trips)}


def build(config: dict, material: dict, root, device: torch.device) -> Solver:
    return Solver(config, material, root, device)


def split(config: dict, material: dict, root, device: torch.device, answer: dict) -> dict:
    """{"layout", "before", "resumed"}: the port's mesh, its answer after
    all but the last of `answer`'s load trips, and its answer resumed from
    there to the end."""
    from fem_elastoplasticity_tpu_torch.solve.newton import carry_of

    solver = Solver(config, material, root, device, max_trips=max(int(answer["trips"]) - 1, 1))
    raw = solver.request()
    before = solver.answer(raw)
    resumed = solver.answer(solver.request(resume=carry_of(raw)))
    return {"layout": solver.layout, "before": before, "resumed": resumed}
