"""The port's compute ops.  ``set_kernels`` picks the route of the whole
process, as TPU.USE_PALLAS does in the JAX package (engine/loop.py:60-71,
serve.py:44-56): the hand-written kernels ("cuda": the LSTM scan K1-K3
and the fused observation ops K4-K7) or none of them ("plain")."""


def set_kernels(on: bool) -> None:
    """Set both backends (``rnn`` and ``fused_obs``), in either direction."""
    from . import fused_obs, rnn

    name = "cuda" if on else "plain"
    rnn.set_backend(name)
    fused_obs.set_backend(name)
