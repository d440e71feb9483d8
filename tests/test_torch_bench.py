"""The port's measurement helpers on the CPU: the conv1d yardstick computes
the Toeplitz conv's function, the bounds follow their formulas, and the
SASS counter finds and classifies a kernel's main loop."""
import numpy as np
import pytest
import torch

from openpbso_tpu_torch.bench import roofline, sass_count
from openpbso_tpu_torch.bench.toeplitz_ab import conv1d_call
from openpbso_tpu_torch.ops.toeplitz_conv import toeplitz_conv_reference


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("o,nl,k,x,c", [
    (2, 1, 1, 5, 16),
    (3, 2, 3, 4, 7),
    (1, 3, 2, 6, 1),
])
def test_conv1d_yardstick_computes_the_toeplitz_conv(o, nl, k, x, c):
    """float64, so no TF32 path of cuDNN or rounding order can hide a
    wrong layout."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((o, nl, k, c)))
    f = torch.from_numpy(rng.standard_normal((o, k, x, c)))
    call, result = conv1d_call(g, f)
    assert call().shape == (x, o * nl, 2 * c - 1)
    np.testing.assert_allclose(result().numpy(),
                               toeplitz_conv_reference(g, f).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_toeplitz_conv_bound_at_the_span_headline():
    b = roofline.toeplitz_conv(256, 1, 1, 512, 512)
    assert b["flops"] == 2 * 256 * 512 * 512 * 513 // 2
    assert b["bytes"] == 4 * (256 * 512 + 2 * 256 * 512 * 512)
    assert b["tf32x3_ms"] == pytest.approx(3 * b["fp32_ms"] * 67 / 495)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.2086, abs=1e-4)
    assert b["fp32_ms"] == pytest.approx(0.5138, abs=1e-4)


@pytest.mark.parametrize("per_item,lanes", [
    ({"int": 64.0, "fp32": 10.0}, 1.0),              # the ALU
    ({"imad": 100.0, "fp32": 28.0}, 1.0),            # the FMA pipe
    ({"int": 30.0, "fp32": 30.0, "other": 196.0}, 2.0),   # the issue
])
def test_integer_bound_takes_the_busiest_pipe(per_item, lanes):
    n, clock = 132 * 1000, 1e9
    assert roofline.integer_ms(n, per_item, clock) == pytest.approx(
        1e3 * n * lanes / (132 * clock))


def test_ar_block_bound_is_its_dependent_chain():
    """S x 3 dependent FP32 operations of 4 clocks: ~3.1 us at S = 512 and
    1980 MHz, above the issue time of 256 objects' draws."""
    per_sample = {"int": 61.0, "imad": 20.0, "fp32": 26.0, "other": 15.0}
    b = roofline.ar_block(256, 512, per_sample, 1980e6)
    assert b["chain_ms"] == pytest.approx(512 * 3 * 4 / 1980e6 * 1e3)
    assert b["chain_ms"] == pytest.approx(0.0031, abs=1e-4)
    assert b["chain_ms"] > b["issue_ms"] > b["bytes_ms"]
    assert b["bound_ms"] == b["chain_ms"]
    assert b["bound_by"] == "operations"


_SASS = """
        Function : _Z6kernelPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0020*/                   IMAD.IADD R2, R0, 0x1, R3 ;
        /*0030*/                   LOP3.LUT R2, R2, 0xff, RZ, 0xc0, !PT ;
        /*0040*/                   FFMA R4, R2, R2, R4 ;
        /*0050*/              @!P0 SHF.L.W.U32.HI R5, R2, 0xd, R2 ;
        /*0060*/                   STG.E [R6.64], R4 ;
        /*0070*/                   STG.E [R6.64+0x4], R5 ;
        /*0080*/               @P1 BRA `(.L_x_0) ;
        /*0090*/                   EXIT ;
"""


def test_sass_count_finds_and_classifies_the_main_loop(monkeypatch):
    monkeypatch.setattr(sass_count, "sass", lambda library: _SASS)
    out = sass_count.count("lib.so", "kernel")
    assert out["loop_instructions"] == 7 and out["per_iteration"] == 2
    assert out["by_class"] == {"imad": 1, "int": 2, "fp32": 1, "mem": 2,
                               "other": 1}
    assert out["by_class_per_item"]["int"] == 1.0
    with pytest.raises(ValueError, match="no loop"):
        sass_count.count("lib.so", "kernel", per="HMMA")
