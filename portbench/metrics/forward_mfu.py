"""The whole step's share of the card's dense bf16 (or float32) peak of the
data sheet, in %: the model's FLOPs, counted over the plain reference at the
cell's shapes, of the pairs served outside the profiled slice, over the
host seconds of those calls."""


def read(rec):
    return rec.forward_mfu()
