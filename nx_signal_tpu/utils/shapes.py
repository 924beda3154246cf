"""Static shape math helpers (the host-side "deftransform" analog).

All shape computation happens at Python level so every traced function sees
static shapes — the JAX analog of the reference's deftransform/defn split
(reference: lib/nx_signal.ex:68-86 vs :88-130).
"""


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (reference `fft_length: :power_of_two`,
    lib/nx_signal.ex:78)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def fft_fast_length(n: int) -> int:
    """FFT length used for convolution padding: the next power of two.

    Some FFT backends lower non-power-of-two sizes to a dense O(N^2) DFT
    matmul (measured: a 486000-point request tried to allocate the full
    N x N f32 matrix), so convolution FFTs are always padded to pow-2 —
    exact-length slicing keeps results identical to the N+K-1 definition
    (reference: lib/nx_signal/convolution.ex:260-263).
    """
    return next_power_of_two(n)


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a * 3^b * 5^c) integer >= n — the CPU-FFT
    notion of a fast size (scipy.fft.next_fast_len analog). Convolutions use
    `fft_fast_length` (pow-2) instead; see that docstring for why.
    """
    if n <= 6:
        return max(n, 1)
    best = next_power_of_two(n)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # pow2 factor on top of p35
            need = -(-n // p35)  # ceil(n / p35)
            pow2 = 1 << max(0, (need - 1).bit_length())
            best = min(best, p35 * pow2)
            p35 *= 3
        p5 *= 5
    return best


def conv_output_length(n: int, k: int, mode: str) -> int:
    if mode == "full":
        return n + k - 1
    if mode == "same":
        return n
    if mode == "valid":
        return n - k + 1
    raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")
