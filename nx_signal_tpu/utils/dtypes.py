"""Dtype policy helpers.

The framework is float32-first: every op that produces floating
point data defaults to float32 regardless of the `jax_enable_x64` flag, so
behavior is identical on the accelerator and on CPU test runs (x64 enabled so
the few f64 pockets — Wiener accumulation, Lambert W — stay exact).

Mirrors the reference dtype conventions (reference: lib/nx_signal/windows.ex
`type: {:f, 32}` defaults; lib/nx_signal/convolution.ex result promotion).
"""

import jax.numpy as jnp
import numpy as np

DEFAULT_FLOAT = jnp.float32


def is_complex_dtype(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)


def default_complex(float_dtype=DEFAULT_FLOAT):
    """Complex dtype whose parts have the given float dtype."""
    return jnp.dtype(np.result_type(np.dtype(float_dtype), np.complex64))


def complex_part_dtype(complex_dtype):
    """float dtype of the real/imag parts of a complex dtype."""
    return jnp.zeros((), dtype=complex_dtype).real.dtype


def result_real_dtype(*dtypes):
    """Float dtype for results of float math on the given input dtypes.

    Integer/bool inputs promote to float32 (like Nx's f32 promotion on
    `Nx.conv`; reference: test/nx_signal/convolutions_test.exs:392-416).
    """
    out = np.dtype(np.float32)
    for d in dtypes:
        d = np.dtype(d)
        if np.issubdtype(d, np.complexfloating):
            d = np.dtype(np.float64) if d == np.complex128 else np.dtype(np.float32)
        if np.issubdtype(d, np.floating):
            out = np.promote_types(out, d)
    return jnp.dtype(out)
