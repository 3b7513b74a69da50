"""The ring kernels' ordering (B6, B7) as a model of its counters in plain Python.

``parallel/ring_pallas.py`` orders each put against the neighbours' use of a
receive slot with 64-bit counters in the receiver's buffer, on the device
only: no host step after a key's first call. For call N of a key
(``ring_step(N)``) a rank's stream runs, in this order:

- a rank that puts (``ring_roles``): wait until the right neighbour's
  ``consumed[slot] >= reuse`` (no wait below 1), then the put's blocks, in
  any order: each stores its part of the payload into the right
  neighbour's slot and counts itself in this rank's ``done[slot]``; the
  block that finishes the count zeroes it and releases ``sent[slot] = N``
  there;
- a rank that receives: wait until its own ``sent[slot] >= arrival``, read
  the slot, release ``consumed[slot] = N``.

The model runs every stream's steps in order, the streams and the put's
blocks interleaved at random from a seed (any order the hosts and the card
could give), over 1-4 ranks, 1-12 calls, two keys interleaved in one SPMD
order, puts of 1-3 blocks, and each call of a rank on one of two streams
(nothing makes a caller issue a key's calls on one stream). Every read must
see the left neighbour's whole payload of the same call of the same key, no
put may land in a slot whose payload is still unread, and every run must
finish. The slot count, the targets and the counters' layout come from
``ring_pallas`` itself; a deliberately wrong rule or layout must fail.
"""

import random

import pytest

from digital_signal_processsing_tpu_torch.parallel import ring_pallas
from digital_signal_processsing_tpu_torch.parallel.ring_pallas import RingStep, ring_roles

SEEDS = range(400)


def rank_streams(rank: int, world: int, calls: list[str], step_of, rnd) -> list[list[tuple]]:
    """The device steps of ``rank``'s two streams, each in order: (op, key, step)."""
    receives, puts = ring_roles(world, rank)
    streams, counts = [[], []], {}
    for key in calls:
        counts[key] = counts.get(key, 0) + 1
        s = step_of(counts[key])
        program = streams[rnd.randint(0, 1)]
        if puts:
            if s.reuse >= 1:
                program.append(("wait_consumed", key, s))
            program.append(("put", key, s))
        if receives:
            program += [("wait_sent", key, s), ("read", key, s), ("release_consumed", key, s)]
    return streams


def run_model(seed: int, step_of=ring_pallas.ring_step, offset=ring_pallas.counter_offset) -> int:
    """One random interleaving; raises AssertionError on a broken rule. Returns the reads."""
    rnd = random.Random(seed)
    world = rnd.randint(1, 4)
    blocks = rnd.randint(1, 3)
    calls = [rnd.choice("ab") for _ in range(rnd.randint(1, 12))]
    counter: dict = {}  # (rank, key, byte offset in the rank's header): value, 0 at first
    slots: dict = {}  # (rank, key, slot): (the payload's parts by block, unread)

    def at(r: int, key: str, name: str, slot: int) -> tuple:
        return (r, key, offset(name, slot))

    streams = [(r, prog) for r in range(world)
               for prog in rank_streams(r, world, calls, step_of, rnd)]
    pc = [0] * len(streams)
    todo: list = [None] * len(streams)  # the blocks of the put at a stream's pc, not yet run
    reads = 0

    def moves(i: int) -> list:
        r, prog = streams[i]
        if pc[i] == len(prog):
            return []
        op, key, s = prog[pc[i]]
        if op == "wait_consumed" and counter.get(at(r + 1, key, "consumed", s.slot), 0) < s.reuse:
            return []
        if op == "wait_sent" and counter.get(at(r, key, "sent", s.slot), 0) < s.arrival:
            return []
        if op == "put":
            if todo[i] is None:
                todo[i] = set(range(blocks))
            return [(i, b) for b in sorted(todo[i])]
        return [(i, None)]

    while True:
        ready = [m for i in range(len(streams)) for m in moves(i)]
        if not ready:
            break
        i, block = rnd.choice(ready)
        r, prog = streams[i]
        op, key, s = prog[pc[i]]
        if op == "put":
            where = (r + 1, key, s.slot)
            parts, unread = slots.get(where, ({}, False))
            mine = (key, r, s.call)
            assert not unread or set(parts.values()) <= {mine}, (
                f"seed {seed}: rank {r} call {s.call} overwrote an unread slot")
            parts = {**parts, block: mine} if unread else {block: mine}
            slots[where] = (parts, True)
            done = at(r, key, "done", s.slot)
            counter[done] = counter.get(done, 0) + 1
            if counter[done] == blocks:  # this block finished the count: zero it, release sent
                counter[done] = 0
                counter[at(r + 1, key, "sent", s.slot)] = s.call
            todo[i].discard(block)
            if not todo[i]:
                todo[i], pc[i] = None, pc[i] + 1
            continue
        pc[i] += 1
        if op == "read":
            where = (r, key, s.slot)
            parts, _ = slots.get(where, ({}, False))
            want = {b: (key, r - 1, s.call) for b in range(blocks)}
            assert parts == want, f"seed {seed}: rank {r} call {s.call} of {key} read {parts}"
            slots[where] = (parts, False)
            reads += 1
        elif op == "release_consumed":
            counter[at(r, key, "consumed", s.slot)] = s.call
    stuck = [(r, prog[pc[i]][:2]) for i, (r, prog) in enumerate(streams) if pc[i] < len(prog)]
    assert not stuck, f"seed {seed}: no stream can go on: {stuck}"
    assert reads == (world - 1) * len(calls)
    return reads


@pytest.mark.parametrize("chunk", range(4))
def test_every_read_sees_its_call(chunk):
    """Over the seeds (in four cases), every interleaving keeps the rule."""
    reads = sum(run_model(seed) for seed in SEEDS if seed % 4 == chunk)
    assert reads > 0


def test_targets_name_the_call():
    """Call N of a key: slot (N - 1) % RING_SLOTS, the put waits for call N -
    RING_SLOTS's read of that slot, the read for call N's put; every counter
    of every slot on a line of its own inside the header."""
    assert ring_pallas.RING_SLOTS == 2
    for n in range(1, 9):
        s = ring_pallas.ring_step(n)
        assert (s.call, s.slot, s.reuse, s.arrival) == (n, (n - 1) % 2, n - 2, n)
    with pytest.raises(ValueError, match="count from 1"):
        ring_pallas.ring_step(0)
    assert [ring_roles(4, t) for t in range(4)] == [(False, True), (True, True), (True, True),
                                                    (True, False)]
    assert ring_roles(1, 0) == (False, False)
    lines = [ring_pallas.counter_offset(name, slot) for name in ring_pallas.COUNTERS
             for slot in range(ring_pallas.RING_SLOTS)]
    assert len(set(lines)) == len(lines) and all(o % 128 == 0 for o in lines)
    assert max(lines) + 8 <= ring_pallas._HEADER


def one_slot(call: int) -> RingStep:
    """Wrong: one slot, but the put still waits only for call N - 2's read."""
    s = ring_pallas.ring_step(call)
    return RingStep(call=call, slot=0, reuse=s.reuse, arrival=s.arrival)


def early_read(call: int) -> RingStep:
    """Wrong: the read waits for sent >= call - 1, the previous call's put."""
    s = ring_pallas.ring_step(call)
    return RingStep(call=call, slot=s.slot, reuse=s.reuse, arrival=call - 1)


def no_reuse_wait(call: int) -> RingStep:
    """Wrong: the put never waits for the slot's last read."""
    s = ring_pallas.ring_step(call)
    return RingStep(call=call, slot=s.slot, reuse=0, arrival=s.arrival)


def shared_done(name: str, slot: int) -> int:
    """Wrong: one count of finished blocks for both slots."""
    return ring_pallas.counter_offset(name, 0 if name == "done" else slot)


@pytest.mark.parametrize("wrong", [one_slot, early_read, no_reuse_wait, shared_done])
def test_a_wrong_rule_fails(wrong):
    """The model can fail: each wrong rule or layout breaks some interleaving."""
    kw = {"offset": wrong} if wrong is shared_done else {"step_of": wrong}
    failed = 0
    for seed in SEEDS:
        try:
            run_model(seed, **kw)
        except AssertionError:
            failed += 1
    assert failed > 0
