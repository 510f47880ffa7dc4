"""Operation and byte counts of the yardstick against values worked by hand
at two shapes (the train cells' d_sae 16384 and the wide cells' 32768)."""

import pytest

from perfbench.lib import work

BF16, F32, HBM = 989e12, 67e12, 3.35e12


def test_peaks():
    assert work.PEAK_OPS["bf16"] == BF16 and work.PEAK_OPS["f32"] == F32 and work.HBM_BYTES_S == HBM


@pytest.mark.parametrize("s, k, want_s", [
    # The encoder's bf16 product: 2 x 16384 x 1024 x 16384 = 549755813888 operations = 555.9 us at 989
    # TFLOP/s; its bytes, 2 x (16.8M + 16.8M) + 2 x 268.4M = 604.0 MB = 180.3 us: bound by operations.
    (16384, 32, 549755813888 / BF16),
    # At d_sae 32768: 1099511627776 operations = 1111.7 us.
    (32768, 64, 1099511627776 / BF16),
])
def test_dense_bf16_product(s, k, want_s):
    density = work.latent_density(s, 1024, k, 512)
    got = work.product_bound_s("aten::mm", [[16384, 1024], [1024, s]], ["c10::BFloat16", "c10::BFloat16"],
                               16384, density)
    assert got == pytest.approx(want_s, rel=1e-12)


@pytest.mark.parametrize("s, k, want_bytes", [
    # The f32 decode of TopK latents: 2 x 16384 x 32 x 1024 = 1.07 G operations (16 us at 67 TFLOP/s);
    # bytes 4 x (16384 x 16384 + 16384 x 1024) + 4 x 16384 x 1024 = 1207959552 (360.6 us): bound by bytes.
    (16384, 32, 1207959552),
    # d_sae 32768, k 64: 4 x (536870912 + 33554432) + 67108864 = 2348810240 bytes (701.1 us).
    (32768, 64, 2348810240),
])
def test_sparse_f32_decode(s, k, want_bytes):
    density = work.latent_density(s, 1024, k)
    got = work.product_bound_s("aten::mm", [[16384, s], [s, 1024]], ["float", "float"], 16384, density)
    assert got == pytest.approx(want_bytes / HBM, rel=1e-12)


def test_weight_gradient_counts_the_sparse_gradient():
    # [x; 1]^T @ dh, bf16, x padded to 1032 columns, dh with 32 of 16384 nonzero a row:
    # operations 2 x 1032 x 16384 x 16384 x 32 / 16384 = 1.08 G (1.1 us); bytes 2 x (1032 x 16384 + 16384 x 16384)
    # + 2 x 1032 x 16384 = 604.6 MB (180.5 us): bound by bytes.
    density = work.latent_density(16384, 1024, 32, 512)
    got = work.product_bound_s("aten::mm", [[1032, 16384], [16384, 16384]], ["c10::BFloat16", "c10::BFloat16"],
                               16384, density)
    assert got == pytest.approx((2 * (1032 * 16384 + 16384 * 16384) + 2 * 1032 * 16384) / HBM, rel=1e-12)


@pytest.mark.parametrize("kernel, want", [("nvjet_tss_192x192_64x3_2x1_v_bz_coopB_NNN", "bf16"),
                                          ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8", "f32"),
                                          ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>", "f32"),
                                          ("void gemv2T_kernel_val<int, int, float, float>", None)])
def test_precision_from_kernel_names(kernel, want):
    assert work.precision_of(None, (kernel,)) == want
    assert work.precision_of(["c10::BFloat16", "c10::BFloat16"], (kernel,)) == "bf16"


def test_unknown_precision_is_silent():
    assert work.product_bound_s("aten::mm", [[4, 4], [4, 4]], ["int"], 4, lambda w, output=False: None) is None


@pytest.mark.parametrize("s, k, n_dead", [(16384, 32, 819), (32768, 64, 1638)])
def test_train_step_model(s, k, n_dead):
    b, d, k_aux = 16384, 1024, 512
    m = work.train_step_model_s(b, d, s, k, n_dead, k_aux)
    # K2-K4 read f once as stored (bf16), W_dec, x, b_dec and write x_hat, dW_dec, db_dec and df at f's nonzeros:
    # at d_sae 16384, 2 x 268.4M + 4 x (2 x 16.8M + 2 x 16.8M + 2048 + 524288) = 807.4 MB = 241.0 us.
    mat = (2 * b * s + 4 * (2 * s * d + 2 * b * d + 2 * d + b * k)) / HBM
    assert m["matryoshka"] == pytest.approx(mat)
    if s == 16384:
        assert mat == pytest.approx(807_411_712 / HBM, rel=1e-6)
    # K1 reads h once (1.07 GB at 16384: 320.5 us); K5 the dead columns.
    sel = (4 * b * s + 6 * b * k + 12 * b + s) / HBM + (4 * b * n_dead + s + 4 * b) / HBM
    assert m["select"] == pytest.approx(sel)
    assert m["model"] == pytest.approx((2 * b * d * s + 2 * b * k * (d + 1) + 2 * b * d * n_dead + 6 * b * k_aux * d
                                        + 6 * b * k * d) / BF16)


@pytest.mark.parametrize("s, k", [(16384, 32), (32768, 64)])
def test_log_step_and_inference_models(s, k):
    b, d = 16384, 1024
    log = work.log_step_model_s(b, d, s, k)
    assert log["model"] == pytest.approx((2 * b * d * s + 2 * b * k * d + s * s * d) / F32)
    assert log["select"] == pytest.approx((4 * b * s + 4 * b) / HBM)
    inf = work.infer_batch_model_s(b, d, s, k)
    # The encoder's f32 product: at d_sae 32768, 1.1 T operations = 16.4 ms at 67 TFLOP/s.
    assert inf["model"] == pytest.approx((2 * b * d * s + 2 * b * k * d) / F32)
    if s == 32768:
        assert 2 * b * d * s / F32 == pytest.approx(0.016411, rel=1e-4)
