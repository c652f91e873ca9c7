"""CUDA graph capture shared by the port's compiled steps: the counterpart
of ``jax.jit``'s compile-once, replay-after of the JAX package.

Every captured step follows one recipe (:func:`capture_step`): the step
runs once eagerly on a side stream -- it builds the kernels' libraries and
sizes their per-device scratch, so nothing is allocated under capture --
then, after a device sync, it is captured with ``capture_begin`` into a
memory pool its owner shares among its graphs, with the sampler's
``torch.Generator`` registered where the step draws from it. The launch
counts of the step are recorded at capture and added back to the counters
at every replay (``kernels.add_launches``), since a replay runs no Python.
A graph's owner keeps the kernels' scratch (``kernels.scratch_in_use``),
the parameters and the adapter it captured alive beside it. A capture that
fails raises: no owner falls back to an eager step on the card.

Each owner keeps a :class:`GraphTable` and runs its step through
``GraphTable.run``, which replays, captures or runs eagerly: the model's
``forward`` (a table on each cache, a graph per chunk key),
the generator's ``DecodeLoop`` (a graph per attend-length bucket) and the
serving engine (its decode and speculative steps). One switch,
``ExLlama.capture``, decides for all of them: with ``capture = False``, on
the CPU or on a mesh of more than one rank each runs the same step eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from exllama_tpu_torch import kernels


def capture_step(step, dev, stream, pool, generator=None):
    """Run ``step()`` eagerly on ``stream`` (it builds the kernels'
    libraries and sizes their scratch), then capture it into a new
    ``torch.cuda.CUDAGraph`` in ``pool``, with ``generator``'s state
    registered where the step draws from it. Returns (graph, the launch
    counts of one step): the capture records them and takes them back off
    the counters, since a capture launches nothing."""
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        step()
    cur.wait_stream(stream)
    # the eager step done before the capture starts: without this sync
    # a sampled step's replays drew other tokens than the eager step
    # (tests/test_torch_kernels.py, a sampled case after a greedy one)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = kernels.launch_counts()
    # capture_begin / _end rather than the torch.cuda.graph context,
    # which also empties the allocator's cache at every capture: the
    # next prefill would cudaMalloc its buffers again
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            step()
        finally:
            graph.capture_end()
    after = kernels.launch_counts()
    counts = {k: after[k] - before[k] for k in after
              if after[k] != before[k]}
    kernels.add_launches(counts, -1)      # capture launched nothing
    return graph, counts


@dataclasses.dataclass
class _Graph:
    """A captured step: its static inputs, read where they lie at every
    replay, and its output in the table's pool."""

    graph: object
    counts: dict
    inputs: tuple
    out: Optional[torch.Tensor]
    keep: tuple                     # scratch, params, what the owner names


class GraphTable(dict):
    """Captured steps by key, with the side stream they are captured on and
    the memory pool they share, both made at the first capture. An entry
    lives as long as the table holds it."""

    def __init__(self):
        super().__init__()
        self._stream = self._pool = None

    def clear(self):
        """Drop every graph, and with them their pool (a pool whose graphs
        are all gone cannot take a new capture)."""
        super().clear()
        self._pool = None

    def run(self, model, key, step, *inputs, generator=None, keep=()):
        """``step(*inputs)`` for ``model``: replayed from the graph of
        ``key``, captured at the key's first call, or run eagerly where
        :func:`eager` says so. At the capture ``inputs`` (tensors or None)
        are copied into static buffers that the graph reads; a replay copies
        them in, replays, adds the captured launch counts to the counters
        and returns a copy of the step's output (the next replay overwrites
        the original). The capture returns the output of its eager run.
        ``generator``: the ``torch.Generator`` the step draws from;
        ``keep``: what else the graph reads that its owner may drop."""
        if eager(model):
            return step(*inputs)
        entry = self.get(key)
        if entry is not None:
            for buf, x in zip(entry.inputs, inputs):
                if buf is not None:
                    buf.copy_(x)
            entry.graph.replay()
            kernels.add_launches(entry.counts)
            return None if entry.out is None else entry.out.clone()
        # the parameters' device, with its index: the kernels' scratch is
        # filed under it (``kernels.scratch_in_use``)
        dev = model.params.embed.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = tuple(None if x is None else x.clone() for x in inputs)
        outs = []
        graph, counts = capture_step(lambda: outs.append(step(*static)), dev,
                                     self._stream, self._pool, generator)
        self[key] = _Graph(graph, counts, static, outs[1],
                           (kernels.scratch_in_use(dev), model.params, *keep))
        return outs[0]


def eager(model) -> bool:
    """Whether ``model``'s steps run eagerly: ``model.capture`` is False,
    it runs on the CPU, or on a mesh of more than one rank."""
    return not (model.capture and model.device.type == "cuda"
                and one_rank(model))


def one_rank(model) -> bool:
    """Whether ``model`` runs on one rank: a graph cannot capture a gloo
    collective, and the capture of an NCCL one is not checked yet, so a
    mesh of more than one rank runs its steps eagerly."""
    mesh = getattr(model, "mesh", None)
    return mesh is None or mesh.tp * mesh.dp * mesh.size("sp") == 1
