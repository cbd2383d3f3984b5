"""The loss and every gradient leaf of ``Model.loss_fn`` against
``jax.value_and_grad`` of the reference's, for the cross-attention families
(whisper, the vision model with its gates at 0.7) and recurrentgemma: the
second half of ``test_torch_train_step.py``'s families, with its weights,
inputs and tolerances (the loss within 1e-5, each gradient leaf within 1e-4
of its max-abs)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check_family  # noqa: E402


@pytest.mark.parametrize("family", ["recurrentgemma", "vision", "whisper"])
def test_loss_and_gradients_match_the_reference(family):
    check_family(family)
