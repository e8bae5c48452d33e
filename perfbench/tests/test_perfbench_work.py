"""The work counts the roofline and MFU metrics divide by."""

from perfbench.harness import work

SIZES = (2049, 1024, 512, 128, 32, 1)


def test_qnet_row_and_parameter_counts():
    assert work.qnet_row_flops(SIZES) == 5_384_256
    assert work.qnet_params(SIZES) == 2_693_825


def test_learner_update_flops_at_the_cell_and_at_the_dryrun_shape():
    # B 32 x C 64: the cell's worker update
    assert work.learner_update_flops(SIZES, 32, 64) == 22_436_517_888
    # B 256 x C 160: equals op_walk's count of the damoldqn train step
    assert work.learner_update_flops(SIZES, 256, 160) == 444_139_094_016


def test_dispatch_bound_is_the_larger_term():
    few = work.qnet_dispatch_bound_s(SIZES, 1)
    assert few == 4 * (2_693_825 + 2050) / work.HBM_BYTES_PER_S
    many = work.qnet_dispatch_bound_s(SIZES, 10_000)
    assert many == 10_000 * 5_384_256 / work.F32_PEAK_FLOPS
