"""The port's data pipeline against the reference's: the same NumPy
generators drawn in the same order, so batches are equal to the bit
(`np.array_equal`, dtype included), straggler choice and all."""
import numpy as np
import pytest

from repro import configs as JC
from repro.data import DataPipeline as JPipe
from repro.data import PipelineConfig as JPipeCfg
from repro.data import synth_batch as j_synth_batch
from repro.models.config import ShapeConfig as JShape

from repro_torch import configs as TC
from repro_torch.data import DataPipeline, PipelineConfig, ShardStats, \
    synth_batch
from repro_torch.models.config import ShapeConfig

NAMES = ["granite-3-2b", "mixtral-8x22b", "musicgen-medium",
         "llava-next-34b", "zamba2-2.7b"]


def shapes(seq, batch):
    return JShape("tiny", seq, batch, "train"), \
        ShapeConfig("tiny", seq, batch, "train")


def assert_batches_equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        assert np.array_equal(t[k], j[k]), k


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("override", [None, 3])
def test_synth_batch_equals_reference(name, override):
    js, ts = shapes(32, 8)
    j = j_synth_batch(JC.get(name).reduced(), js, np.random.default_rng(5),
                      batch_override=override)
    t = synth_batch(TC.get(name).reduced(), ts, np.random.default_rng(5),
                    batch_override=override)
    assert_batches_equal(t, j)
    assert t["labels"].shape == (override or 8, 32)
    if "tokens" in t:                       # next-token structure
        assert np.array_equal(t["tokens"][:, 1:], t["labels"][:, :-1])


@pytest.mark.parametrize("slow,factor", [((), 3.0), ((2,), 2.0),
                                         ((0, 3), 2.0), ((1, 2, 3), 1.5)])
def test_pipeline_batches_and_straggler_choice_equal_reference(slow, factor):
    """12 steps of 4 shards with some shards slow: the same healthy set
    after every step and the same batches, resampled from the same
    shards; the global batch never shrinks and the healthy floor holds."""
    js, ts = shapes(16, 8)
    delay = lambda s, step: 10.0 + step if s in slow else 0.1 * (s + 1)
    jp = JPipe(JC.get("granite-3-2b").reduced(), js, 4, seed=3,
               pipe_cfg=JPipeCfg(straggler_factor=factor),
               shard_delay=delay)
    tp = DataPipeline(TC.get("granite-3-2b").reduced(), ts, 4, seed=3,
                      pipe_cfg=PipelineConfig(straggler_factor=factor),
                      shard_delay=delay)
    for _ in range(12):
        assert tp.healthy_shards() == jp.healthy_shards()
        t, j = tp.next_batch(), jp.next_batch()
        assert_batches_equal(t, j)
        assert t["labels"].shape[0] == 8
    assert [s.median for s in tp.stats] == [s.median for s in jp.stats]
    assert len(tp.healthy_shards()) >= 2
    if len(slow) == 1:                      # the one straggler is flagged
        assert slow[0] not in tp.healthy_shards()


def test_prefetch_iterator_yields_the_dispatcher_batches():
    """The prefetch thread calls `next_batch` in order: the iterator's
    batches are those of a second pipeline stepped by hand."""
    _, ts = shapes(16, 4)
    cfg = TC.get("granite-3-2b").reduced()
    it = iter(DataPipeline(cfg, ts, 2, seed=1))
    ref = DataPipeline(cfg, ts, 2, seed=1)
    for _ in range(5):
        assert_batches_equal(next(it), ref.next_batch())
    it.close()


def test_shard_stats_window_and_bad_split():
    s = ShardStats(3)
    assert s.median == 0.0
    for dt in (5.0, 1.0, 2.0, 9.0):
        s.push(dt)
    assert list(s.lat) == [1.0, 2.0, 9.0] and s.median == 2.0
    _, ts = shapes(16, 6)
    with pytest.raises(ValueError, match="does not split"):
        DataPipeline(TC.get("granite-3-2b").reduced(), ts, 4)
