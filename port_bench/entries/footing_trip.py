"""The strip footing's load trip resumed from a banked state: `build_df32(
FootingConfig.fast_scale(L, max_trips=...))` of the port and its
`run(resume=carry)` as a request, the carry loaded once at set-up from the
checkpoint file the configuration names (held to its SHA-256)."""
from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch


class Solver:
    def __init__(self, config: dict, material: dict, root, device: torch.device):
        from fem_elastoplasticity_tpu_torch.models import footing
        from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
        from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

        path = root / config["checkpoint"]
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != config["checkpoint_sha256"]:
            raise ValueError(f"{config['checkpoint']}: SHA-256 {digest}, the configuration "
                             f"states {config['checkpoint_sha256']}")
        self.cfg = FootingConfig.fast_scale(
            int(config["level"]), size_xy=float(config["size_xy"]), young=float(config["young"]),
            poisson=float(config["poisson"]), cohesion=float(material["cohesion"]),
            friction_angle=math.radians(float(material["friction_angle_deg"])),
            max_trips=int(config["trips"]), **config["preset"])
        t0 = time.perf_counter()
        self._run, mesh = footing.build_df32(self.cfg, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_s = time.perf_counter() - t0
        self.carry = load_checkpoint(path, device=device)
        self.layout = (np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems))
        self._base = (int(self.carry["ncg_total"]), int(self.carry["nits_total"]),
                      int(self.carry["step"]))

    def request(self):
        return self._run(resume=self.carry)

    def counts(self, raw) -> dict:
        cg0, newton0, step0 = self._base
        return {"cg": int(raw.n_cg_total) - cg0, "newton": int(raw.n_newton_total) - newton0,
                "steps": int(raw.n_steps) + 1 - step0, "plastic": int(raw.n_plastic),
                "zeta": float(raw.carry["zeta_old"])}

    def answer(self, raw) -> dict:
        n = int(raw.n_steps)
        return {"u": np.asarray(raw.u, np.float64), "ep": np.asarray(raw.ep, np.float64),
                "zeta": float(raw.carry["zeta_old"]), "n_steps": n,
                "zeta_hist": np.asarray(raw.zeta_hist, np.float64)[1:n + 1]}


def build(config: dict, material: dict, root, device: torch.device) -> Solver:
    return Solver(config, material, root, device)
