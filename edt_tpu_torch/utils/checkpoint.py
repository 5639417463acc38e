"""Checkpoint/resume of training state (counterpart of
``edt_tpu.utils.checkpoint``), over ``torch.save`` and
``torch.load(weights_only=True)``: tensors and plain values only, never a
pickle of arbitrary objects.

Usage:
    from edt_tpu_torch.utils import checkpoint as ckpt
    mgr = ckpt.Manager("runs/run1", max_to_keep=3)
    mgr.save(step, {"params": model.state_dict(),
                    "opt_state": opt.state_dict()})
    state = mgr.restore({"params": model.state_dict(),
                         "opt_state": opt.state_dict()})
    step = mgr.latest_step()
"""

from __future__ import annotations

import os

import torch


def _to_template_devices(value, template):
    """``value`` with each tensor on the device of the template's tensor at
    the same place; tensors the template does not hold stay on the CPU."""
    if isinstance(value, torch.Tensor):
        if isinstance(template, torch.Tensor):
            return value.to(template.device)
        return value
    if isinstance(value, dict):
        sub = template if isinstance(template, dict) else {}
        return {k: _to_template_devices(v, sub.get(k)) for k, v in
                value.items()}
    if isinstance(value, (list, tuple)):
        sub = template if isinstance(template, (list, tuple)) else ()
        out = [_to_template_devices(v, sub[i] if i < len(sub) else None)
               for i, v in enumerate(value)]
        return type(value)(out)
    return value


class Manager:
    """Steps kept as one file each, ``ckpt_<step>.pt`` in ``directory``;
    saving a step past ``max_to_keep`` deletes the oldest."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, f"ckpt_{step:012d}.pt")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".pt"):
                out.append(int(name[5:-3]))
        return sorted(out)

    def save(self, step: int, state) -> None:
        """Write ``state``, a nested dict of tensors and plain values
        (lists, tuples, numbers, strings, None), as step ``step``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """The state saved at ``step`` (default: the latest), each tensor on
        the device of ``template``'s tensor at the same place."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return _to_template_devices(state, template)
