"""The program's sampled actions, read as it makes them.

A ``TorchFunctionMode`` that keeps the output of every ``torch.argmax``
over a float [B, K] tensor: the agents' sampled and greedy action
choices.  It observes and changes nothing; the runners open it only
around the checked steps, which run before the window.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


class ActionSpy(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.actions = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.argmax and args and args[0].dim() == 2 and args[0].is_floating_point():
            self.actions.append(out.detach().clone())
        return out
