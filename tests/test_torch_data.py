"""Port parity of the synthetic LM data (``repro_torch/data/pipeline.py``):
token and embedding batches bit for bit the JAX package's for every
(seed, step, process), and the default process from ``torch.distributed``
(0 of 1 when it is not initialised)."""
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM


@pytest.mark.parametrize("kind", ["tokens", "embeddings"])
@pytest.mark.parametrize("seed,pi,pc", [(0, 0, 1), (3, 1, 2), (7, 3, 4)])
def test_batches_are_the_reference_s_bit_for_bit(kind, seed, pi, pc):
    args = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed, input_kind=kind,
                d_model=16)
    ref = JaxSyntheticLM(JaxDataConfig(**args), process_index=pi, process_count=pc)
    port = SyntheticLM(DataConfig(**args), process_index=pi, process_count=pc)
    assert port.local_batch == ref.local_batch == 8 // pc
    for step in (0, 1, 17, 10_000):
        want, got = ref.batch(step), port.batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].tobytes() == want[key].tobytes(), (key, step)
    it = port.iterate(5)
    for step in (5, 6):
        assert next(it)["labels"].tobytes() == ref.batch(step)["labels"].tobytes()


def test_default_process_is_torch_distributed_s():
    """Without an initialised process group the stream is process 0 of 1
    (the reference asks ``jax.process_index``, also 0 of 1 here)."""
    port = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=4))
    ref = JaxSyntheticLM(JaxDataConfig(vocab_size=50, seq_len=8, global_batch=4))
    assert (port.pi, port.pc) == (ref.pi, ref.pc) == (0, 1)
    assert port.batch(3)["tokens"].tobytes() == ref.batch(3)["tokens"].tobytes()
