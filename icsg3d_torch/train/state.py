"""Train state: the model (its parameters and BatchNorm buffers), the Adam
optimizer and the step count.

Counterpart of icsg3d_tpu/train/state.py.  The optimizer is
``torch.optim.Adam`` with optax.adam's defaults (b1 0.9, b2 0.999, eps
1e-8, eps_root 0, no weight decay; train/vae.py:43); its update,
lr * m_hat / (sqrt(v_hat) + eps), is optax's.  ``arrays``/``load_arrays``
carry the whole state as a flat Flax-named dict of numpy arrays, the
port's checkpoint format (train/checkpoints.py).

``group`` (a torch.distributed process group, default None) is the data
axis across processes: ``reduce_gradients`` averages the gradients over its
ranks before the Adam step, so every rank applies the global batch's
update to its replica of the parameters.

On CUDA parameters Adam is ``capturable``: its step count and bias
correction live on the card, so an update can be captured in a CUDA graph
(train/graphs.py) and the per-step and captured epochs take the same
update, bit for bit.  On the CPU it is torch's default Adam (torch refuses
``capturable`` there).  ``step``, the host's count, is advanced by
``apply_gradients`` or, for replayed steps, by the epoch program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from icsg3d_torch.parallel import distributed
from icsg3d_torch.weights import (
    flatten,
    flax_key,
    load_flax_variables,
    model_variables,
    to_flax_variables,
    unflatten,
)

MOMENTS = ("mu", "nu")  # optax's names for Adam's exp_avg / exp_avg_sq
_TORCH_MOMENT = {"mu": "exp_avg", "nu": "exp_avg_sq"}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    group: object = None

    @classmethod
    def create(cls, model: nn.Module, learning_rate: float,
               group=None) -> "TrainState":
        cuda = next(model.parameters()).is_cuda
        adam = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                                capturable=cuda)
        return cls(model, adam, 0, group)

    def reduce_gradients(self) -> None:
        """Average the gradients over ``group``'s ranks (one all-reduce of
        a flat buffer); a no-op for a single process."""
        if self.group is not None:
            distributed.reduce_gradients(self.model.parameters(), self.group)

    def update(self) -> None:
        """The device work of the update after ``backward``: the gradients'
        all-reduce and one Adam step (the step count is the caller's)."""
        self.reduce_gradients()
        self.optimizer.step()

    def apply_gradients(self) -> None:
        """The update after ``backward``: ``update``, then the step count."""
        self.update()
        self.step += 1

    def arrays(self, with_optimizer: bool = True) -> Dict[str, np.ndarray]:
        """Flat Flax-named state: params/..., batch_stats/..., step, and with
        the optimizer opt_state/mu/params/... and opt_state/nu/params/...
        (zeros before the first update, as optax initialises them)."""
        flat = flatten(to_flax_variables(self.model))
        flat["step"] = np.asarray(self.step, np.int64)
        if with_optimizer:
            for name, p in self.model.named_parameters():
                st = self.optimizer.state.get(p, {})
                for m in MOMENTS:
                    t = st.get(_TORCH_MOMENT[m])
                    flat[f"opt_state/{m}/{flax_key(name)}"] = (
                        t.detach().float().cpu().numpy() if t is not None
                        else np.zeros(tuple(p.shape), np.float32)
                    )
        return flat

    def load_arrays(self, flat: Dict[str, np.ndarray]) -> None:
        """Restore from ``arrays()`` output: the model always; the optimizer
        moments when the dict holds them (``latest``, not ``best``)."""
        tree = unflatten(flat)
        load_flax_variables(self.model, model_variables(tree))
        self.step = int(flat["step"]) if "step" in flat else self.step
        if not any(k.startswith("opt_state/") for k in flat):
            return
        for name, p in self.model.named_parameters():
            st = self.optimizer.state[p]
            # on the parameter's device: capturable Adam keeps it there
            st["step"] = torch.tensor(float(self.step), dtype=torch.float32,
                                      device=p.device)
            for m in MOMENTS:
                st[_TORCH_MOMENT[m]] = torch.from_numpy(
                    np.asarray(flat[f"opt_state/{m}/{flax_key(name)}"], np.float32)
                ).to(p.device)
