"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold that version to the JAX function (the Pallas kernel in interpret
mode, as the JAX package's own tests run it) on the same numpy inputs.
tests/test_torch_cuda.py holds the hand-written kernels to the plain
versions on a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _golden_coarse(y, w2):
    return lax.conv_general_dilated(
        jnp.asarray(y), jnp.asarray(w2), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


class TestSubpixelOps:
    def test_s2d_d2s_match_jax(self, rng):
        from srgan_st_tpu.ops import subpixel_conv as jsc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        x = rng.random((2, 8, 12, 8), dtype=np.float32)
        np.testing.assert_array_equal(
            tsc.space_to_depth(_t(x), 2).numpy(),
            np.asarray(jsc.space_to_depth(jnp.asarray(x), 2)))
        np.testing.assert_array_equal(
            tsc.depth_to_space(_t(x), 2).numpy(),
            np.asarray(jsc.depth_to_space(jnp.asarray(x), 2)))

    @pytest.mark.parametrize("k,f", [(9, 2), (9, 4), (5, 2)])
    def test_coarse_kernel_matches_jax(self, rng, k, f):
        from srgan_st_tpu.ops import subpixel_conv as jsc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        w = rng.random((k, k, 4, 3), dtype=np.float32) - 0.5
        np.testing.assert_array_equal(
            tsc._coarse_kernel(_t(w), f).numpy(),
            np.asarray(jsc._coarse_kernel(jnp.asarray(w), f)))

    @pytest.mark.parametrize("inner", [1, 2, None, "pallas", "pallas-tiled"])
    def test_pre_shuffled_matches_jax(self, rng, inner):
        """Every inner factoring of the fused reconstruction conv equals the
        JAX plain composition; tolerance: f32 accumulation order."""
        from srgan_st_tpu.ops import subpixel_conv as jsc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        y = rng.random((2, 8, 12, 16), dtype=np.float32)
        w = rng.random((9, 9, 4, 3), dtype=np.float32) - 0.5
        b = rng.random((3,), dtype=np.float32)
        golden = jsc.conv2d_subpixel_pre_shuffled(
            jnp.asarray(y), jnp.asarray(w), jnp.asarray(b), factor=2,
            inner_factor=1)
        got = tsc.conv2d_subpixel_pre_shuffled(_t(y), _t(w), _t(b), factor=2,
                                               inner_factor=inner)
        np.testing.assert_allclose(got.numpy(), np.asarray(golden), atol=1e-4)

    def test_odd_dims_take_plain_path(self, rng, monkeypatch):
        """The kernel's shape gate: odd H or W never reaches the coarse conv
        kernel wrapper (a shape gate, as in the JAX package)."""
        from srgan_st_tpu_torch.kernels import coarse_conv as cc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        calls = []
        monkeypatch.setattr(cc, "coarse_conv_s2d",
                            lambda *a: calls.append(1) or cc.coarse_conv_s2d_reference(*a))
        w = _t(rng.random((9, 9, 4, 3), dtype=np.float32) - 0.5)
        tsc.conv2d_subpixel_pre_shuffled(
            _t(rng.random((1, 7, 8, 16), dtype=np.float32)), w, None, inner_factor=None)
        assert calls == []
        tsc.conv2d_subpixel_pre_shuffled(
            _t(rng.random((1, 8, 8, 16), dtype=np.float32)), w, None, inner_factor=None)
        assert calls == [1]

    @pytest.mark.parametrize("shape", [(1, 16, 12, 3), (1, 10, 12, 3)])
    def test_conv2d_subpixel_matches_jax(self, rng, shape):
        """The s2d(4) stem formulation (and its direct-conv fallback when
        H, W are not divisible by 4)."""
        from srgan_st_tpu.ops import subpixel_conv as jsc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        x = rng.random(shape, dtype=np.float32)
        w = rng.random((9, 9, 3, 8), dtype=np.float32) - 0.5
        b = rng.random((8,), dtype=np.float32)
        golden = jsc.conv2d_subpixel(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), factor=4)
        got = tsc.conv2d_subpixel(_t(x), _t(w), _t(b), factor=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(golden), atol=1e-4)


class TestCoarseConv:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 8, 4), (1, 12, 16, 16, 3)])
    def test_plain_matches_jax_kernel(self, rng, shape):
        """The plain version == the JAX one-block Pallas kernel (interpret
        mode); atol 1e-4 is the JAX test's own gate."""
        from srgan_st_tpu.kernels.coarse_conv import coarse_conv_s2d as jax_cc
        from srgan_st_tpu_torch.kernels import coarse_conv as cc

        b, h, w, c, n2 = shape
        y = rng.random((b, h, w, c), dtype=np.float32)
        w2 = rng.random((5, 5, c, n2), dtype=np.float32) - 0.5
        want = np.asarray(jax_cc(jnp.asarray(y), jnp.asarray(w2), interpret=True))
        before = cc.launches
        got = cc.coarse_conv_s2d(_t(y), _t(w2))
        assert cc.launches == before  # a CPU tensor never launches
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(_golden_coarse(y, w2)).reshape(b, h // 2, 2, w // 2, 2, n2)
            .transpose(0, 1, 3, 5, 2, 4).reshape(want.shape), atol=1e-4)

    def test_plain_matches_jax_tiled_kernel(self, rng, monkeypatch):
        """The multi-tile shape through the JAX H-tiled kernel (budgets shrunk
        as in the JAX package's own test so several H tiles run)."""
        from srgan_st_tpu.kernels import coarse_conv as jcc
        from srgan_st_tpu_torch.kernels import coarse_conv as cc

        b, h, w, c, n2 = 1, 24, 16, 16, 3
        y = rng.random((b, h, w, c), dtype=np.float32)
        w2 = rng.random((5, 5, c, n2), dtype=np.float32) - 0.5
        monkeypatch.setattr(jcc, "ONE_BLOCK_BYTES", 0)
        hc, wc, c2, n3 = h // 2, w // 2, 2 * c, 4 * n2
        th0, wp8 = hc // 2, -(-(wc + 2) // 8) * 8
        budget = (2 * (th0 + 2) * 2 * wp8 * c2 * 2
                  + 4 * th0 * wc * c2 * 2 + 2 * th0 * wc * n3 * 4
                  + 18 * c2 * n3 * 2)
        monkeypatch.setattr(jcc, "TILED_BUDGET_BYTES", budget)
        assert jcc._pick_tile(hc, wc, c2, n3) < hc
        want = np.asarray(jcc.coarse_conv_s2d(jnp.asarray(y), jnp.asarray(w2),
                                              interpret=True))
        got = cc.coarse_conv_s2d(_t(y), _t(w2))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    def test_w3_blocks_match_jax(self, rng):
        from srgan_st_tpu.kernels.coarse_conv import _w3_blocks as jax_w3
        from srgan_st_tpu_torch.kernels.coarse_conv import _w3_blocks

        w2 = rng.random((5, 5, 8, 12), dtype=np.float32) - 0.5
        np.testing.assert_array_equal(_w3_blocks(_t(w2)).numpy(),
                                      np.asarray(jax_w3(jnp.asarray(w2))))

    def test_kernel_layout_reproduces_plain(self, rng):
        """The wrapper's (18, 48, 2C) weight layout and the (H, W/2, 2C) view
        of x, contracted as csrc/coarse_conv.cu does (18 taps over the
        padded window), give the plain version: the kernel's indexing,
        checked on the CPU."""
        from srgan_st_tpu_torch.kernels.coarse_conv import (
            _kernel_weights, coarse_conv_s2d_reference,
        )

        b, h, w, c = 2, 8, 12, 16
        x = _t(rng.random((b, h, w, c), dtype=np.float32))
        w2 = _t(rng.random((5, 5, c, 12), dtype=np.float32) - 0.5)
        wt = _kernel_weights(w2, x.device, x.dtype)
        assert tuple(wt.shape) == (18, 48, 2 * c)
        xp = torch.nn.functional.pad(x.reshape(b, h, w // 2, 2 * c),
                                     (0, 0, 1, 1, 2, 2))
        hc, wc = h // 2, w // 2
        out = torch.zeros(b, hc, wc, 48)
        for tap in range(18):
            qy, ry, qx = tap // 6, (tap // 3) % 2, tap % 3
            rows = xp[:, 2 * qy + ry: 2 * qy + ry + 2 * hc: 2, qx: qx + wc]
            out += rows @ wt[tap].T
        np.testing.assert_allclose(out.numpy(),
                                   coarse_conv_s2d_reference(x, w2).numpy(),
                                   atol=1e-4)


class TestServingTail:
    @staticmethod
    def _args(rng, b=1, h=8, w=8, c=64, n=3):
        f = lambda *s: rng.random(s, dtype=np.float32) - 0.5  # noqa: E731
        # kernels scaled to ~1/sqrt(fan_in) so activations stay O(1), as in
        # a trained network; atol then measures the algorithm, not f32 eps
        # at |out| ~ 70
        return (f(b, h, w, c), f(3, 3, c, 4 * c) * 0.1, f(4 * c),
                np.float32(0.25), f(9, 9, c, n) * 0.03, f(n))

    @pytest.mark.parametrize("shape", [(1, 8, 8), (2, 12, 16)])
    def test_plain_matches_jax_kernel(self, rng, shape):
        """The plain version == the JAX fused-tail Pallas kernel (interpret
        mode); atol 2e-4 is the JAX test's own gate."""
        from srgan_st_tpu.kernels.serving_tail import serving_tail as jax_tail
        from srgan_st_tpu_torch.kernels import serving_tail as st

        b, h, w = shape
        args = self._args(rng, b, h, w)
        want = np.asarray(jax_tail(*map(jnp.asarray, args), interpret=True))
        before = st.launches
        got = st.serving_tail(*(_t(a) for a in args))
        assert st.launches == before
        assert tuple(got.shape) == (b, 2 * h, 2 * w, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)

    def test_fits_budget_gate(self):
        from srgan_st_tpu_torch.kernels.serving_tail import fits_budget

        assert fits_budget(540, 960, 64, 256, 3)
        assert not fits_budget(541, 960, 64, 256, 3)
        assert not fits_budget(540, 960, 32, 128, 3)

    def test_serving_tail_kernel_layout_reproduces_plain(self, rng):
        """The wrapper's stage-1 (9, 256, 64) and stage-2 (18, 48, 512)
        weight layouts, contracted as csrc/serving_tail.cu does (stage 1
        zeroed outside the image, then the 18 taps over the window), and
        the wrapper's output permutation give the plain version."""
        from srgan_st_tpu_torch.kernels import serving_tail as st
        from srgan_st_tpu_torch.kernels.coarse_conv import _kernel_weights
        from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

        b, h, w = 1, 6, 8
        y, w_up, b_up, alpha, w3, b3 = (_t(a) for a in self._args(rng, b, h, w))
        w1t = w_up.permute(0, 1, 3, 2).reshape(9, 256, 64)
        yp = torch.nn.functional.pad(y, (0, 0, 1, 1, 1, 1))
        t = sum(yp[:, dy:dy + h, dx:dx + w] @ w1t[3 * dy + dx].T
                for dy in range(3) for dx in range(3)) + b_up
        t = torch.where(t >= 0, t, alpha * t)  # (b, h, w, 256), zero pad below
        wt = _kernel_weights(_coarse_kernel(w3, 2), y.device, y.dtype)
        tp = torch.nn.functional.pad(t.reshape(b, h, w // 2, 512), (0, 0, 1, 1, 2, 2))
        z = torch.zeros(b, h // 2, w // 2, 48)
        for tap in range(18):
            qy, ry, qx = tap // 6, (tap // 3) % 2, tap % 3
            z += tp[:, 2 * qy + ry: 2 * qy + ry + h: 2, qx: qx + w // 2] @ wt[tap].T
        zc = z.reshape(b, h // 2, w // 2, 3, 2, 2, 2, 2).permute(0, 1, 6, 4, 2, 7, 5, 3)
        got = zc.reshape(b, 2 * h, 2 * w, 3) + b3
        np.testing.assert_allclose(
            got.numpy(), st.serving_tail_reference(y, w_up, b_up, alpha, w3, b3).numpy(),
            atol=2e-4)


class TestGates:
    def test_coarse_conv_fits(self):
        from srgan_st_tpu_torch.kernels.coarse_conv import fits

        bf, f32 = torch.bfloat16, torch.float32
        assert fits((1, 1080, 1920, 256), (5, 5, 256, 12), bf)
        assert fits((2, 8, 8, 8), (5, 5, 8, 12), f32)
        assert not fits((2, 8, 8, 8), (5, 5, 8, 12), bf)   # C % 16 for bf16
        assert not fits((1, 9, 8, 16), (5, 5, 16, 12), f32)  # odd H
        assert not fits((1, 8, 8, 16), (5, 5, 16, 4), f32)   # 1 output channel
        assert not fits((1, 8, 8, 16), (3, 3, 16, 12), f32)  # not a 9x9 conv
        assert not fits((1, 8, 8, 16), (5, 5, 16, 12), torch.float64)

    def test_pre_shuffled_reference_matches_jax(self, rng):
        from srgan_st_tpu.ops import subpixel_conv as jsc
        from srgan_st_tpu_torch.ops import subpixel_conv as tsc

        y = rng.random((1, 6, 8, 8), dtype=np.float32)
        w = rng.random((9, 9, 2, 3), dtype=np.float32) - 0.5
        b = rng.random((3,), dtype=np.float32)
        np.testing.assert_allclose(
            tsc._pre_shuffled_f2_reference(_t(y), _t(w), _t(b)).numpy(),
            np.asarray(jsc._pre_shuffled_f2_reference(*map(jnp.asarray, (y, w, b)))),
            atol=1e-4)

    def test_wrapper_raises_off_gate(self, rng):
        """A tensor on a device with no kernel and no plain path raises;
        nothing falls back."""
        from srgan_st_tpu_torch.kernels import coarse_conv as cc
        from srgan_st_tpu_torch.kernels import serving_tail as st

        x = torch.zeros(1, 8, 8, 16, device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            cc.coarse_conv_s2d(x, torch.zeros(5, 5, 16, 12, device="meta"))
        with pytest.raises(ValueError, match="no kernel for device"):
            st._launch(torch.zeros(1, 8, 8, 64, device="meta"), None, None, None, None)
