"""Plain reference of LightGBM's binary log-loss gradients
(binary_objective.hpp): labels {0, 1} read as -1 and +1,
response = -y * sigma / (1 + exp(y * sigma * score)),
g = response, h = |response| * (sigma - |response|); no class weights,
an initial score of 0."""

from __future__ import annotations

import numpy as np
import torch


def prepare(label: np.ndarray, group, params: dict, device) -> dict:
    y = torch.from_numpy(np.where(np.asarray(label) > 0, 1.0, -1.0)).to(device)
    return {"y": y, "sigmoid": float(params.get("sigmoid", 1.0))}


def gradients(state: dict, score: torch.Tensor):
    y, sig = state["y"].to(score.dtype), state["sigmoid"]
    response = -y * sig / (1.0 + torch.exp(y * sig * score))
    a = torch.abs(response)
    return response, a * (sig - a)
