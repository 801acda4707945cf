"""Clean wire usage: consumers go through the transport primitives."""
from repro_torch.core.transport import wire_aggregate, wire_corrupt


def via_wire(gen, values, mask):
    corrupted = wire_corrupt(gen, values, mask, attack="scale")
    return wire_aggregate(corrupted, "median")
