"""Port parity, the token pipeline: ``repro_torch.data.TokenPipeline``
against the reference's, bitwise (both are the same numpy arithmetic on
uint64 counters), over vocabularies, shapes, seeds and steps, host shards
included; then twins of the token tests of ``tests/test_data.py``."""

import itertools

import numpy as np
import pytest

from repro.data import TokenPipeline as RPipeline

from repro_torch.data import TokenPipeline

SHAPES = [  # vocab, seq_len, global_batch, seed
    (256, 32, 4, 0), (1000, 16, 4, 1), (256000, 1024, 4, 0), (7, 3, 8, 12345),
    (50, 8, 8, 2 ** 40 + 3),
]
STEPS = (0, 1, 7, 123_456_789, 2 ** 41 + 5)


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
@pytest.mark.parametrize("vocab,seq,batch,seed", SHAPES)
def test_batches_equal_the_reference_bitwise(vocab, seq, batch, seed):
    ours, ref = TokenPipeline(vocab, seq, batch, seed), RPipeline(vocab, seq, batch, seed)
    for step in STEPS:
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.dtype == want.dtype == np.int32 and got.shape == (batch, seq)
        np.testing.assert_array_equal(got, want)


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
@pytest.mark.parametrize("num_hosts", [1, 2, 4, 8])
def test_host_shards_equal_the_reference_bitwise(num_hosts):
    ours, ref = TokenPipeline(50, 8, 8, seed=3), RPipeline(50, 8, 8, seed=3)
    for step, host in itertools.product((0, 5, 99), range(num_hosts)):
        np.testing.assert_array_equal(ours.host_shard_at(step, host, num_hosts),
                                      ref.host_shard_at(step, host, num_hosts))


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
def test_iteration_follows_the_step_counter():
    ours, ref = TokenPipeline(100, 8, 2, seed=4), RPipeline(100, 8, 2, seed=4)
    for step, (got, want) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ours.batch_at(step))
        if step == 3:
            break


def test_a_batch_that_does_not_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(50, 8, 6).host_shard_at(0, 0, 4)


# -- twins of tests/test_data.py ---------------------------------------------------


def test_pipeline_deterministic_and_step_dependent():
    p = TokenPipeline(vocab_size=1000, seq_len=16, global_batch=4, seed=1)
    a1, a2 = p.batch_at(3), p.batch_at(3)
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(p.batch_at(3), p.batch_at(4))
    assert a1.shape == (4, 16) and a1.dtype == np.int32
    assert a1.min() >= 0 and a1.max() < 1000


def test_pipeline_host_shards_partition_batch():
    p = TokenPipeline(vocab_size=50, seq_len=8, global_batch=8, seed=0)
    full = p.batch_at(7)
    parts = [p.host_shard_at(7, h, 4) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_pipeline_different_seeds_differ():
    a = TokenPipeline(vocab_size=50, seq_len=8, global_batch=2, seed=0).batch_at(0)
    b = TokenPipeline(vocab_size=50, seq_len=8, global_batch=2, seed=1).batch_at(0)
    assert not np.array_equal(a, b)
