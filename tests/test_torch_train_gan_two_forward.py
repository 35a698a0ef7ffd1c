"""The GAN step with `gan_single_forward=False` (a second generator forward
for the G phase) against dlsg_tpu's, as in test_torch_train_steps.py (same
setup and tolerances); a file of its own so that xdist runs its JAX compile
beside the other file's."""

from test_torch_train_steps import check_gan_case, one_torch_thread, run_gan_case  # noqa: F401


def test_gan_step_two_forwards_matches_jax():
    check_gan_case(*run_gan_case(single_fwd=False))
