"""`Super5.run` of muscle_tpu_torch end to end on the CPU, against
muscle_tpu on the same numpy-seeded set: 3 families x 8 proteins of
60-90 aa, 2 duplicates and 3 near-duplicates, refine_iters=2, with the
joins where each package's default puts them and with every PProg and
refine join forced to the device in both.
"""

import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.alphabet import ALPHA_AMINO as J_AMINO
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu_torch import MultiSequence
from muscle_tpu_torch.alphabet import ALPHA_AMINO
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.pipeline import mpc as t_mpc
from muscle_tpu_torch.pipeline import pprog as t_pp
from muscle_tpu_torch.pipeline.super5 import LAST_RUN, Super5
from test_torch_pprog import _families_text


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU scan runs many small ops, which gain nothing from
    intra-op threads; one thread keeps it from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("joins", ["host", "device"])
def test_super5_matches_jax(joins, monkeypatch):
    """Super5.run on 3 families x 8 sequences of 60-90 aa, 2 duplicates
    and 3 near-duplicates, refine_iters=2: the AFA text equals
    muscle_tpu's, with the joins where each package's default puts them
    (host: every join has < 64 pairs) or forced to the device in both
    (PProg joins and the clusters' refine joins)."""
    if joins == "device":
        monkeypatch.setattr(t_pp, "DEVICE_JOIN_N", 1)
        monkeypatch.setattr(t_mpc, "DEVICE_REFINE_N", 1)
        monkeypatch.setenv("MUSCLE_TPU_DEVICE_REFINE", "1")
    else:
        monkeypatch.delenv("MUSCLE_TPU_DEVICE_REFINE", raising=False)
    from muscle_tpu.pipeline.super5 import Super5 as JSuper5
    text = _families_text(5)
    ours = Super5(refine_iters=2, device="cpu").run(
        MultiSequence.from_fasta(text), HMMParams.from_defaults(),
        ALPHA_AMINO)
    ref = JSuper5(refine_iters=2).run(
        muscle_tpu.MultiSequence.from_fasta(text),
        JHMMParams.from_defaults(), J_AMINO)
    assert ours.to_fasta_text() == ref.to_fasta_text()
    assert LAST_RUN["unique"] == 27 and LAST_RUN["members"] > 0
    assert len(LAST_RUN["clusters"]) > 1
    n_joins = len(LAST_RUN["clusters"]) - 1
    want = ({"device": 0, "host": n_joins} if joins == "host"
            else {"device": n_joins, "host": 0})
    assert LAST_RUN["pprog_joins"] == want
