"""The banded merge: `recon -fast -band 3 -guide` on small4, port against
the JAX package (CPU, float64).  small4's four sequences are all 300 aa,
so small4.fa itself is a gapless guide; a 3-wide band around its
diagonal constrains every merge (the envelope's vector mask in the
bridge), and the rows must still be byte-identical, `#=GF LP` within
1e-6."""

from tests.test_torch_recon import rows_and_lp, run, write_small4


def test_banded_guide_matches_jax(tmp_path):
    fa, nh = write_small4(tmp_path)
    args = ["-fast", "-band", "3", "-guide", fa, "-tree", nh]
    ref = run("historian_tpu", args, HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="1",
              HISTORIAN_DEVICE_TRACE="1", HISTORIAN_DEVICE_DTYPE="f64")
    assert ref.returncode == 0, ref.stderr[-2000:]
    out = run("historian_tpu_torch", ["-platform", "cpu", *args], HISTORIAN_DEVICE_DTYPE="f64")
    assert out.returncode == 0, out.stderr[-2000:]
    (rows, lp), (ref_rows, ref_lp) = rows_and_lp(out.stdout), rows_and_lp(ref.stdout)
    assert rows == ref_rows and len(rows) == 7
    assert abs(lp - ref_lp) < 1e-6
    # the band binds: the unbanded reconstruction scores higher
    free = run("historian_tpu_torch", ["-platform", "cpu", "-fast", "-noband", "-tree", nh, fa])
    assert rows_and_lp(free.stdout)[1] > lp + 100
