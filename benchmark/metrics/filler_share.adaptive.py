"""The adaptive rounds' filler: slot-steps that advanced a dead filler
slot (``adaptive.filler_slot_steps``, (B - live slots) x steps a round)
over all slot-steps (``adaptive.slot_steps``, B x steps a round) of the
traced calls, in percent. A count; it changes with the seed."""
from benchmark.metrics import _program


def read(rec):
    return _program.counter_ratio(("adaptive.filler_slot_steps",), "adaptive.slot_steps",
                                  100.0)
