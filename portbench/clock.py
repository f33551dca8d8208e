"""Completion marks for blocks: CUDA events on the card, the host clock on
the CPU (the harness's own tests run there)."""
from __future__ import annotations

import time

import torch


class HostMark:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end: "HostMark") -> float:
        return (end.t - self.t) * 1e3


def mark(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostMark()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
