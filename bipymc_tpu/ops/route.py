"""Where this package's Pallas kernels run: the one place that decides.

Every fused kernel asks :func:`interpret_mode` how to run. On the CPU —
the test platform — a kernel runs in Pallas interpret mode; on a CUDA
GPU it compiles through Pallas-Triton (``backend="triton"``, named
explicitly: JAX's default GPU route is Mosaic GPU). Any other platform
raises. There is no silent fallback: an accelerator never runs an
interpreter, and a failed compile is an error, not a slower path.

Triton refuses arrays whose size is not a power of two, so the kernels
pad the dimension axis with :func:`next_pow2` (100 → 128, 5 → 8, 2 → 2)
and block chains in power-of-two groups.
"""

import jax

#: the custom-call target a Pallas-Triton kernel lowers to in the HLO
TRITON_CALL_TARGET = "__gpu$xla.gpu.triton"


def interpret_mode(platform: str | None = None) -> bool:
    """True on ``cpu`` (interpret), False on ``gpu`` (Triton); raises on
    any other platform. ``platform`` defaults to JAX's default backend."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"no kernel route for platform {platform!r}: the fused kernels "
        "compile for 'gpu' through Pallas-Triton and run in interpret "
        "mode on 'cpu'")


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (≥ 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is ≥ ``x``."""
    return (x + m - 1) // m * m

