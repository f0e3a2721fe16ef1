"""The GPipe train step with tensor parallelism of the RWKV, Mamba and
encoder-decoder blocks across ranks on the CPU (gloo): the reduced
rwkv6-3b at tp=2, jamba-1.5-large-398b (MAMBA_MLP, MAMBA_MOE and
ATTN_MOE) at tp=2, and whisper-small at tp=4 (encoder half T / 2), held as
tests/test_torch_tp_train.py holds its cases (that module's `train_twin`):
the lr-0 loss within 2e-4 of JAX's dense cross-entropy, each rank's leaves
after 2 steps within 1e-5 of its block of the one-process step's, and
every replicated leaf equal on its replicas.  RWKV's replicated decay,
bonus, group-norm gain and decay-LoRA output columns act on the rank's
heads, Mamba's ``in_proj`` holds the rank's block of both halves, and
whisper's encoder half enters the cross-attention's KV heads while it
passes through the decoder layer replicated.
"""

import pytest
import torch

from test_torch_tp_train import train_twin


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,tp", [
    ("rwkv6-3b", 2),
    ("jamba-1.5-large-398b", 2),
    ("whisper-small", 4),
])
def test_trained_across_tensor_ranks_matches_jax_and_one_process(
        arch, tp, tmp_path):
    train_twin(arch, tp, tmp_path)
