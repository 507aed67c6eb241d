"""Operation, byte and FLOP counts against hand arithmetic at one shape."""

from portbench.counts import ops


def test_rot3_bytes_match_the_kernel_table():
    # [512, 256, 256] bf16: 2 x 33.55 M x 2 B + 2 x 512 x 256 x 4 B, 0.0404 ms at 3.35 TB/s
    b = ops.rot3_bytes(512, 256, 2, "fwd")
    assert b == 2 * 512 * 256 * 256 * 2 + 2 * 4 * 512 * 256
    assert abs(b / 3.35e12 * 1e3 - 0.0404) < 1e-4
    assert ops.rot3_bytes(512, 256, 2, "bwd") == 3 * 512 * 65536 * 2 + 4 * 4 * 512 * 256
    assert ops.rot3_bytes(512, 256, 2, "bwd", with_dx=False) == 2 * 512 * 65536 * 2 + 16 * 512 * 256


def test_upconv_bytes_at_stage_zero():
    B, H, W, C = 512, 8, 8, 128
    assert ops.upconv_bytes("upconv_fwd", B, H, W, C, 2) == 2 * (2 * B * 4 * C * H * W + B * 6 * C * 16 + C)
    assert ops.upconv_bytes("upconv_bwd", B, H, W, C, 2) == 2 * (3 * B * 4 * C * H * W + B * 12 * C * 16)
    assert ops.upconv_bytes("upconv_bwd", B, H, W, C, 2, relu=False) == 2 * (2 * B * 4 * C * 64 + B * 12 * C * 16)
    # the four stages of a decoder pass sum to the 0.1617 ms bound of the kernel table
    total = sum(ops.upconv_bytes("upconv_fwd", 512, H, W, C, 2, r)
                for _, H, W, C, r in ops.decoder_stages(128))
    assert abs(total / 3.35e12 * 1e3 - 0.1617) < 1e-3


def test_phasemax_bytes():
    B, H, W, C = 1024, 128, 128, 16
    h, w = 64, 64
    assert ops.upconv_bytes("phasemax_fwd", B, H, W, C, 2) == 2 * (B * 4 * C * h * w + C + B * C * h * w) + B * C * h * w
    assert ops.upconv_bytes("phasemax_bwd", B, H, W, C, 2) == 2 * (B * C * h * w + B * 4 * C * h * w) + B * C * h * w


def test_step_operations():
    train = ops.rvae_ops(128, 32, 512, 2, train=True, paired=True, augmented_rotation=True)
    names = [n for n, _ in train]
    assert names.count("rot3_fwd") == 3 and names.count("rot3_bwd") == 2
    assert names.count("upconv_fwd") == names.count("upconv_bwd") == 4
    assert names.count("phasemax_fwd") == names.count("phasemax_bwd") == 2
    encode = [n for n, _ in ops.rvae_ops(128, 16, 1024, 4, train=False, paired=False,
                                         augmented_rotation=False)]
    assert encode.count("rot3_fwd") == 2 and len(encode) == 8


def test_flops_by_hand():
    # the VAE trunk at 128: 4 stride-2 4x4 convolutions and two 16384 -> 16 dense layers
    trunk = 2 * (1 * 32 * 16 * 64 * 64 + 32 * 64 * 16 * 32 * 32 + 64 * 128 * 16 * 16 * 16
                 + 128 * 256 * 16 * 8 * 8) + 2 * 2 * 16384 * 16
    dec = 2 * 16 * 16384 + 2 * 16 * (256 * 128 * 64 + 128 * 64 * 256 + 64 * 32 * 1024 + 32 * 1 * 4096)
    assert ops.forward_flops("vae", 128, 16) == trunk + dec
    assert ops.train_flops("vae", 128, 16) == 3 * (trunk + dec) - 2 * 32 * 16 * 64 * 64
    stn = 2 * (16 * 25 * 128 * 128 + 16 * 32 * 25 * 64 * 64) + 2 * 32768 * 32 + 2 * 32 * 2
    rdec = 2 * 16 * 16384 + 2 * 9 * (256 * 128 * 256 + 128 * 64 * 1024 + 64 * 32 * 4096 + 32 * 16384)
    assert ops.forward_flops("rvae", 128, 16) == stn + trunk + rdec
    assert ops.train_flops("rvae", 128, 16) == 3 * (2 * stn + trunk + rdec) - 2 * 2 * 16 * 25 * 128 * 128
