"""The control plane of a front end served over a mesh (the port's own; the
JAX package drives every device from one controller and needs none).

The port is SPMD: under ``torchrun`` every rank runs the front end's
``main`` and holds its shard of the model. Rank 0 alone binds the server
and talks to clients; the other ranks (the followers) must run the same
forwards in the same order, or the model's collectives no longer pair. So
rank 0 sends each step's inputs before it runs the step, and the followers
receive them and run it too:

  * :class:`Relay`: a gloo process group over the whole world. Rank 0
    ``send``\\ s small host objects, the followers ``recv`` them, all in
    one order; ``stop`` sends the message that ends the followers' loop.
    gloo also carries these in a world whose data plane is NCCL (an NCCL
    ``broadcast_object_list`` needs a current device and stages through
    it). Its timeout is long: a follower waits in ``recv`` for as long as
    the server is idle;
  * :class:`Mirrored` and :func:`follow_calls`: a generator mirrored at its
    method level. On rank 0 each call of :data:`GENERATOR_CALLS` (the
    calls that touch the model or the cache) is sent, with its arguments
    and a copy of ``generator.settings``, before it runs; a follower
    applies the same calls to its own generator. Host-only state (the
    tokenizer's cache, session files, sockets) stays on rank 0;
  * :func:`relay_for` (the relay of a model's mesh, None off one),
    :func:`is_follower` and :func:`quiet_follower` (a follower's stdout to
    ``/dev/null``).

The continuous-batching engine's relay (one message of new requests before
every ``step()``) is ``serve.api``'s.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import time
from typing import Optional

import torch.distributed as dist

STOP = "stop"
# a follower may wait this long for rank 0's next message (an idle server)
RELAY_TIMEOUT = 30 * 24 * 3600.0

# every method of ExLlamaGenerator / ExLlamaAltGenerator that runs the
# model or changes the cache, the sequence, the sampler's state or the
# decode graphs; a call of another method runs on rank 0 alone
GENERATOR_CALLS = frozenset({
    # ExLlamaGenerator
    "reset", "gen_begin", "gen_begin_empty", "gen_begin_reuse",
    "gen_feed_tokens", "gen_accept_token", "gen_rewind", "gen_prune_right",
    "gen_prune_left", "gen_prune_to", "disallow_tokens", "gen_single_token",
    "gen_tokens", "generate_simple", "generate_cfg", "replace_last_token",
    "begin_beam_search", "beam_search", "end_beam_search",
    # ExLlamaAltGenerator (also gen_begin, gen_begin_reuse, gen_feed_tokens,
    # gen_single_token)
    "begin_stream", "stream", "generate",
})


class Relay:
    """Rank 0's messages to the other ranks of the world, in one order,
    over a gloo group of its own (made here: call it on every rank at the
    same point, as any ``new_group``)."""

    def __init__(self, timeout: float = RELAY_TIMEOUT):
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout))
        self.rank = dist.get_rank()
        self.messages = 0           # sent (rank 0) or received
        self.seconds = 0.0          # in send / recv
        self.stopped = False

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def _carry(self, box: list):
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, src=0, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.messages += 1
        return box[0]

    def send(self, obj):
        """Rank 0: ``obj`` (any picklable host object) to every follower."""
        if not self.leader:
            raise RuntimeError("only rank 0 sends on the relay")
        if self.stopped:
            raise RuntimeError("the relay is stopped")
        self._carry([obj])

    def recv(self):
        """A follower: rank 0's next message (blocks until it comes)."""
        if self.leader:
            raise RuntimeError("rank 0 does not receive on the relay")
        return self._carry([None])

    def stop(self):
        """Rank 0: end the followers' loops (once; later calls do
        nothing)."""
        if not self.stopped:
            self.send(STOP)
            self.stopped = True


def relay_for(model) -> Optional[Relay]:
    """A new :class:`Relay` where ``model`` lies on a mesh of more than one
    rank, else None. Every rank calls it at the same point."""
    if (getattr(model, "mesh", None) is None or not dist.is_initialized()
            or dist.get_world_size() == 1):
        return None
    return Relay()


def is_follower(args) -> bool:
    """Whether this process is a rank other than 0 of the ``--tp`` /
    ``--dp`` mesh that ``args`` ask for (torchrun's ``RANK`` before the
    world is joined)."""
    if args.tp * args.dp == 1:
        return False
    rank = (dist.get_rank() if dist.is_initialized()
            else int(os.environ.get("RANK", "0")))
    return rank != 0


def quiet_follower(args):
    """A context in which a follower's stdout goes to ``/dev/null`` (the
    mains of the benchmark and the front ends); a no-op on rank 0 and off
    a mesh."""
    if is_follower(args):
        return contextlib.redirect_stdout(open(os.devnull, "w"))
    return contextlib.nullcontext()


class Mirrored:
    """Rank 0's view of a generator over a mesh: every attribute is the
    generator's, and each call of :data:`GENERATOR_CALLS` is first sent on
    ``relay`` with its arguments and a copy of the generator's settings. An
    adapter is not relayed (it would cross as pickled tensors): a call with
    one set raises before it is sent."""

    def __init__(self, target, relay: Relay):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_relay", relay)

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        if name not in GENERATOR_CALLS:
            return attr
        target, relay = self._target, self._relay

        def call(*args, **kwargs):
            settings = copy.copy(getattr(target, "settings", None))
            if (getattr(target, "lora", None) is not None
                    or getattr(settings, "lora", None) is not None
                    or any(getattr(a, "lora", None) is not None
                           for a in (*args, *kwargs.values()))):
                raise NotImplementedError(
                    "a LoRA adapter is not relayed to the other ranks of "
                    "the mesh")
            relay.send(("call", name, args, kwargs, settings))
            return attr(*args, **kwargs)

        return call

    def __setattr__(self, name, value):
        setattr(self._target, name, value)


def follow_calls(target, relay: Relay) -> dict:
    """A follower's loop for a :class:`Mirrored` generator: apply each of
    rank 0's calls to ``target`` (its settings first) until the stop
    message. A call that raises here raised on rank 0 too (the same state,
    the same arguments), where it surfaces; the follower notes it and
    carries on. Returns {"calls": n, "errors": [each error's line]}."""
    calls, errors = 0, []
    while True:
        msg = relay.recv()
        if msg == STOP:
            return {"calls": calls, "errors": errors}
        _, name, args, kwargs, settings = msg
        if settings is not None and settings != target.settings:
            target.settings = settings
        calls += 1
        try:
            getattr(target, name)(*args, **kwargs)
        except Exception as e:      # noqa: BLE001 - rank 0 raised it too
            errors.append(f"{type(e).__name__}: {e}")
