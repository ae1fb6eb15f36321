"""The int8 KV cache's dequantization as the CUDA kernels do it, modelled
in numpy on the CPU.

``csrc/paged_attention.cuh`` (``deq4_bits``) and ``attention_mma.cuh``
(``dequant_pair_u``) take an int8 value to float32 with no conversion
instruction: the byte offset by 128 (``x ^ 0x80``) is put under the
exponent of 2^23 by a byte permute (``0x4B0000xx``) and 2^23 + 128 is
subtracted; the result times the key's float32 scale is rounded to bf16
two at a time (``cvt.rn.bf16x2.f32``: round to nearest, ties to even)
and widened back by a shift (low half) or a mask (high half).  The model
below does each step on the bits, for all 256 codes (-128 too, which the
quantizer never writes) against ``ref.dequantize_kv`` (the reference's
``_dequantize_kv``: the product in float32, rounded to the dtype once),
over scales from the quantizer's smallest (1e-8 / 127) to large ones,
powers of two and values whose products tie at bf16's half ulp: equal
bit for bit, in bfloat16 and in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

CODES = np.arange(-128, 128, dtype=np.int8)
# absmax scales as the quantizer makes them (max|t| / 127, at least
# 1e-8 / 127), powers of two, and scales whose products with small codes
# land on bf16 ties (1 + 2^-8: code 1 gives a value halfway between two
# bf16 neighbours)
SCALES = [1e-8 / 127, 3e-5, 0.0078125, 0.01, 1.0 / 127, 0.1234567,
          1.0 + 2.0 ** -8, 1.5 + 2.0 ** -9, 3.0 / 127, 7.25, 250.0 / 127,
          65504.0 / 127]


def permute_to_float(codes):
    """int8 -> float32 as the kernels do: (0x4B000000 | (x ^ 0x80)) as
    float32, less 2^23 + 128, in float32."""
    u = (codes.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32)
    return f - np.float32(8388736.0)


def bf16_pairs_widened(v):
    """float32 values (an even count) -> bf16, rounded to nearest even
    two at a time into one 32-bit word (the first in the low half), then
    widened back: low half << 16, high half & 0xffff0000."""
    bits = v.view(np.uint32).astype(np.uint64)
    r = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    words = (r[0::2] | (r[1::2] << 16)).astype(np.uint32)
    out = np.empty(v.shape, dtype=np.uint32)
    out[0::2] = words << np.uint32(16)
    out[1::2] = words & np.uint32(0xFFFF0000)
    return out.view(np.float32)


def test_byte_permute_is_exact_for_every_code():
    np.testing.assert_array_equal(permute_to_float(CODES),
                                  CODES.astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale", SCALES)
def test_kernel_dequantization_is_the_reference_bit_for_bit(scale, dtype):
    s32 = np.float32(scale)
    v = permute_to_float(CODES) * s32
    got = bf16_pairs_widened(v) if dtype == "bfloat16" else v
    want = ref.dequantize_kv(torch.from_numpy(CODES.copy())[None],
                             torch.tensor([s32]), getattr(torch, dtype))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.float()[0].numpy().view(np.uint32))
