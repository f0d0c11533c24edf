"""The resident epoch as one program on the card (``--epoch-scan``): a train
or eval step captured once as a CUDA graph and replayed for every step.

Counterpart of the ``lax.scan`` epochs of icsg3d_tpu/train/vae.py::
make_vae_epoch_fns (:228-336) and train/unet.py::make_unet_epoch_fns
(:165-227).  There the whole epoch is one jitted program: the host ships
one (n_steps, batch) permutation and fetches one dict of metric means.
Here an ``EpochProgram`` runs one step body over the rows of static device
buffers:

- ``rows`` (n_steps, batch) int64, the epoch's row indices (a device copy
  of what the caller uploaded once);
- ``noise`` (n_steps, ...) optional per-step noise rows, drawn by the
  caller with the per-step path's generator calls;
- ``counter``, a one-element device step counter that the body reads and
  advances, so step i gathers row i of ``rows`` and of ``noise`` and
  writes its metrics into row i of
- ``mets`` (n_steps, k) float32, the concatenated metric tensors of every
  step, fetched once by the caller after the epoch.

The body gathers the batch from the resident split by the row's indices
and runs the step (forward, loss, backward and Adam for a train step).  On
a CUDA model the first ``WARMUP_STEPS`` steps run eagerly on a side
stream (real steps of the epoch: they build and load the kernels, set
their shared-memory limits and create Adam's moments, nothing a capture
may do), then the body is captured once (``torch.cuda.graph``, which
synchronises once before it captures) and every later step, in this epoch
and the next, is one ``replay``: no host sync and no host<->device copy
until the caller's fetch.  On a CPU model every step runs the same body
eagerly through the same buffers.

The captured launches are fixed at capture: the kernels' launch plans,
their TMA descriptors (built on the host from the operands' addresses,
which the graph's private pool keeps) and the launch counters, which
count a capture's launches once.  ``captures`` records, per captured
step, the launches its capture recorded and its replays, so a caller can
count what the card ran: recorded x replays.

The host's ``TrainState.step`` advances once per train step run, eager or
replayed.

Under a process group (data parallelism across processes, one per card)
each rank runs the same program on its block of every step's global
batch: ``epoch_rows`` uploads columns [r*B/W, (r+1)*B/W) of the epoch's
(n_steps, B) permutation, JAX's ``P(None, "data")``.  The step's NCCL
all-reduces (BatchNorm's global moments, their transposes in the
backward, the flat gradient, the metrics) are captured as nodes of the
graph: the warm-up step's first collective creates the communicator, and
``torch.cuda.graph`` synchronises before it captures, so the warm-up's
collectives have completed.  The capture keeps torch's ``"global"`` error
mode: on the card's torch (2.11, NCCL 2.28) ProcessGroupNCCL's watchdog
thread, which queries the events of earlier collectives, invalidated no
capture.  Every rank replays the same graphs in the same order, since
every rank takes the same number of steps.  A gloo group on a CUDA model
(gloo moves CUDA tensors through host memory) and a mesh whose cells sit
on several devices (a graph belongs to one device) are not captured:
``capture_refusal`` names them and the trainers keep the per-step loop
there.  On a CPU model the eager program runs under any group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from icsg3d_torch.parallel.mesh import shard_batch
from icsg3d_torch.train.common import mean_metrics

WARMUP_STEPS = 1


@dataclasses.dataclass
class Capture:
    """One captured step: the kernel launches its capture recorded (from
    ``launch_counts``) and the replays of it so far."""
    name: str
    launches: Dict[str, int]
    replays: int = 0


captures: List[Capture] = []


def reset_captures() -> None:
    captures.clear()


def launch_counts() -> Dict[str, int]:
    """The conv kernels' launch counters (kernels/conv3d.py,
    kernels/conv3d_dw.py), flat."""
    from icsg3d_torch.kernels import conv3d, conv3d_dw

    counts = {
        "conv3d": conv3d.launches, "conv3d_dx": conv3d.launches_dx,
        "conv3d_valid": conv3d.launches_valid,
        "conv3d_dx_valid": conv3d.launches_dx_valid,
        "conv3d_dw": conv3d_dw.launches, "conv3d_dw_valid": conv3d_dw.launches_valid,
    }
    counts.update({f"conv3d[{e}]": n for e, n in conv3d.launches_by_epilogue.items()})
    counts.update({f"conv3d_valid[{e}]": n
                   for e, n in conv3d.launches_valid_by_epilogue.items()})
    return counts


def capture_refusal(state) -> Optional[str]:
    """Why ``state``'s steps cannot be captured, or None where they can
    (the eager program of a CPU model runs under any group)."""
    lead = _indexed(next(state.model.parameters()).device)
    if state.group is not None and lead.type == "cuda":
        backend = dist.get_backend(state.group)
        if backend != "nccl":
            return (f"a {backend} process group: it moves CUDA tensors through "
                    "host memory, which a CUDA graph cannot capture")
    mesh = getattr(state.model, "spatial_mesh", None)
    if mesh is not None:
        devices = {_indexed(d) for d in mesh.devices.flat}
        devices.add(lead)
        if len(devices) > 1:
            return (f"a mesh on {len(devices)} devices: a CUDA graph belongs to "
                    "one device")
    return None


def epoch_rows(order: np.ndarray, n_steps: int, batch: int, device,
               group=None) -> torch.Tensor:
    """The first ``n_steps * batch`` of ``order`` as (n_steps, batch) global
    rows, and of them this rank's columns [r*B/W, (r+1)*B/W) as int64 row
    indices on ``device``: an epoch's one upload.  The columns are what
    JAX's ``P(None, "data")`` puts on data device r, and at each step the
    rows ``shard_batch`` gives the per-step path."""
    rows = order[:n_steps * batch].reshape(n_steps, batch)
    mine = shard_batch(rows.T, group).T
    return torch.from_numpy(np.ascontiguousarray(mine, dtype=np.int64)).to(device)


def run_epoch(programs, state, splits, noise: Optional[Callable] = None):
    """One epoch of a (train, eval) program pair: the train program over
    ``splits[0]`` = (data, rows), then the eval program over ``splits[1]``
    (None without val batches); ``noise(n)`` draws n steps' noise rows.
    Both metric buffers come back in one fetch.  Returns (train means, val
    means, or {} without val batches)."""
    bufs = []
    for program, split in zip(programs, splits):
        if split is not None:
            data, rows = split
            bufs.append(program(state, data, rows,
                                None if noise is None else noise(len(rows))))
    fetched = torch.cat(bufs).cpu().numpy()  # the epoch's one fetch
    n = len(splits[0][1])
    return (programs[0].means(fetched[:n]),
            programs[1].means(fetched[n:]) if len(bufs) > 1 else {})


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class EpochProgram:
    """``step(state, batch, noise_row) -> metrics`` run over an epoch's rows
    (module note).  ``train`` steps advance ``state.step``.

    ``program(state, data, rows, noise=None)`` runs ``len(rows)`` steps on
    the resident split ``data`` (a dict of tensors on the model's device)
    and returns the (n_steps, k) metric buffer, which the next call
    overwrites; ``program.means(host_rows)`` turns its fetched rows into
    the epoch's metric means, as the per-step path's ``mean_metrics``
    takes them.  The graph is kept while ``data``, the rows' shape and the
    noise's shape stay the same; another split or shape captures anew."""

    def __init__(self, name: str, step: Callable, train: bool):
        self.name, self.step, self.train = name, step, train
        self._key = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture: Optional[Capture] = None
        self.layout = None  # [(metric name, shape)] in the buffer's column order
        self.mets = None
        self._eager = 0
        self._stream = None

    def __call__(self, state, data: Dict[str, torch.Tensor], rows: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = next(state.model.parameters()).device
        self._bind(data, rows, noise, device)
        self.rows.copy_(rows)
        if noise is not None:
            self.noise.copy_(noise)
        self.counter.zero_()
        for _ in range(rows.shape[0]):
            if self.graph is None and device.type == "cuda" and self._eager >= WARMUP_STEPS:
                self._capture(state, data)
            if self.graph is not None:
                self.graph.replay()
                self.capture.replays += 1
            else:
                self._run_eager(state, data, device)
            if self.train:
                state.step += 1
        return self.mets

    def means(self, host_rows: np.ndarray) -> dict:
        """Fetched (n_steps, k) rows -> {metric: mean over the steps}."""
        steps = []
        for row in np.asarray(host_rows):
            m, at = {}, 0
            for k, shape in self.layout:
                n = int(np.prod(shape))
                m[k] = row[at:at + n].reshape(shape)
                at += n
            steps.append(m)
        return mean_metrics(steps)

    def _bind(self, data, rows, noise, device) -> None:
        key = (tuple(rows.shape), None if noise is None else tuple(noise.shape),
               tuple((k, v.data_ptr(), tuple(v.shape), v.dtype) for k, v in data.items()))
        if key == self._key:
            return
        self._key = key
        self.graph, self.capture, self.mets, self._eager = None, None, None, 0
        self.rows = torch.empty(rows.shape, dtype=torch.int64, device=device)
        self.noise = (None if noise is None
                      else torch.empty(noise.shape, dtype=noise.dtype, device=device))
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)

    def _body(self, state, data) -> None:
        i = self.counter
        idx = self.rows[i][0]
        batch = {k: v[idx] for k, v in data.items()}
        mets = self.step(state, batch, None if self.noise is None else self.noise[i][0])
        flat = torch.cat([m.detach().float().reshape(-1) for m in mets.values()])
        if self.mets is None:  # the first (eager) step: the buffer and its layout
            self.layout = [(k, tuple(m.shape)) for k, m in mets.items()]
            self.mets = torch.zeros((self.rows.shape[0], flat.numel()),
                                    dtype=torch.float32, device=flat.device)
        self.mets.index_copy_(0, i, flat[None])
        i.add_(1)

    def _run_eager(self, state, data, device) -> None:
        if device.type != "cuda":
            self._body(state, data)
            return
        # torch's capture recipe: warm-up steps on a side stream
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            self._body(state, data)
        current.wait_stream(self._stream)
        self._eager += 1

    def _capture(self, state, data) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body(state, data)
        self.graph = graph
        self.capture = Capture(self.name, {k: v - before[k]
                                           for k, v in launch_counts().items()})
        captures.append(self.capture)
