"""The operations of the work the window completed, over the window's wall,
as a share of the cards' peak for the configuration's arithmetic (989
TFLOP/s a card in bf16): the encoder's forward on the unpadded audio in a
segmenter cell, four forwards a crop a step (the teacher's forward, the
student's forward and backward) in a training cell. The driver counts them."""


def read(obs):
    if not obs["window_s"] or not obs["flops"]:
        return None
    return 100.0 * obs["flops"] / obs["window_s"] / obs["peak_flops"]
