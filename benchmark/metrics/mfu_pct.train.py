"""The whole training step's share of the card's bf16 tensor peak: the
forward and backward FLOPs an image takes on the plain reference at the
cell's shapes, times the images/s of the run's untraced window (all
cards'), over 989 TFLOP/s a card (the data sheet's dense rate at 700 W)."""

from benchmark.reference.roofline import BF16_TENSOR_FLOP_PER_S


def read(window):
    info = window.info
    return (100.0 * info["flop_per_image"] * info["images_per_s"]
            / (BF16_TENSOR_FLOP_PER_S * info.get("cards", 1)))
