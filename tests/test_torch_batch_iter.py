"""The port's batch iterators and the training run's index orders against
the JAX package's (all exact: they are integer sequences).

``BatchIterator`` gives JAX's index sequence with and without shuffling
and cycling, through the wrap-around batch and across epochs;
``ConcurrentBatchIterator`` yields the batches of the iterator it wraps
(in its order with one worker thread, as the same multiset with several);
the device-resident split's index order (``_next_train_idx``) is JAX's;
``encode_batch`` gives JAX's bytes; the synthetic provider's splits have
JAX's sizes and seeds.
"""

import types

import numpy as np
import pytest
import torch

from rec_attend_tpu.data import batch_iter as jbi
from rec_attend_tpu.engine.experiment import TrainingExperiment as JExp
from rec_attend_tpu.parallel import train_step as jts
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.data import batch_iter as bi
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment

torch.set_num_threads(1)


@pytest.mark.parametrize('num,batch_size,cycle,shuffle,stagnant', [
    (10, 3, True, True, False),     # a wrap-around batch each epoch
    (12, 4, True, True, False),     # epochs of whole batches
    (7, 16, True, True, False),     # a batch larger than the split
    (10, 3, False, True, False),    # the last batch short, then stop
    (10, 3, True, False, False),    # in order, wrapping around
    (10, 3, True, True, True),      # stagnant: the same batch
])
def test_batch_iterator_gives_the_jax_sequence(num, batch_size, cycle,
                                               shuffle, stagnant):
  kw = dict(batch_size=batch_size, cycle=cycle, shuffle=shuffle,
            stagnant=stagnant)
  got = bi.BatchIterator(num, **kw)
  want = jbi.BatchIterator(num, **kw)
  n = 0
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
    assert got.epoch == want.epoch
    n += 1
    if n == 25:
      break
  if not cycle:
    assert n == -(-num // batch_size)
    with pytest.raises(StopIteration):
      next(got)
  got.reset()
  want.reset()
  np.testing.assert_array_equal(next(got), next(want))


def test_batch_iterator_stops_after_num_batches():
  got = list(bi.BatchIterator(9, batch_size=2, cycle=True, num_batches=7))
  want = list(jbi.BatchIterator(9, batch_size=2, cycle=True, num_batches=7))
  assert len(got) == len(want) == 7
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)


def _get(idx):
  return {'x': np.asarray(idx, np.float32) / 100.0, 'idx': np.asarray(idx)}


@pytest.mark.parametrize('threads', [1, 3])
def test_concurrent_iterator_yields_the_wrapped_batches(threads):
  n_batches = 12
  want = list(jbi.BatchIterator(10, batch_size=3, cycle=True,
                                num_batches=n_batches, get_fn=_get))
  it = bi.ConcurrentBatchIterator(
      bi.BatchIterator(10, batch_size=3, cycle=True, num_batches=n_batches,
                       get_fn=_get), max_queue_size=4, num_threads=threads)
  got = list(it)
  assert len(got) == n_batches
  if threads == 1:
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g['idx'], w['idx'])
  else:
    assert (sorted(tuple(b['idx']) for b in got)
            == sorted(tuple(b['idx']) for b in want))


def test_concurrent_iterator_relaunches_a_dead_producer():
  calls = []

  def flaky(idx):
    calls.append(1)
    if len(calls) == 2:
      raise RuntimeError('transient')
    return _get(idx)
  it = bi.ConcurrentBatchIterator(
      bi.BatchIterator(6, batch_size=2, cycle=True, num_batches=5,
                       get_fn=flaky), num_threads=1)
  got = list(it)
  # The batch whose read failed is lost, as in JAX's; the rest arrive.
  assert len(got) == 4


@pytest.mark.parametrize('n,bs,seed', [(10, 3, 0), (32, 8, 0), (9, 4, 5)])
def test_device_split_order_is_jax(n, bs, seed):
  """The index vectors of the device-resident split, step by step."""
  def state():
    rng = np.random.RandomState(1234 + seed)
    return types.SimpleNamespace(_idx_rng=rng, _perm=rng.permutation(n),
                                 _ptr=0)
  port, jax_state = state(), state()
  for _ in range(3 * n):
    np.testing.assert_array_equal(
        TrainingExperiment._next_train_idx(port, bs),
        JExp._next_train_idx(jax_state, bs))


def test_encode_batch_gives_the_jax_bytes():
  rng = np.random.RandomState(0)
  batch = {'x': rng.rand(2, 8, 8, 3).astype(np.float32),
           'y_gt': (rng.rand(2, 3, 8, 8) > 0.5).astype(np.float32),
           'c_gt': rng.rand(2, 8, 8, 1).astype(np.float32),
           'd_in': rng.rand(2, 8, 8, 8).astype(np.float32),
           's_gt': np.ones((2, 3), np.float32),
           'idx_map': np.array(['a', 'b'])}
  got, want = ts.encode_batch(batch), jts.encode_batch(batch)
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got[k], want[k])
  assert got['x'].dtype == np.uint8 and got['s_gt'].dtype == np.float32


def test_synthetic_splits_have_the_jax_sizes_and_seeds():
  data = C.DataConfig(dataset='synth', height=32, width=32, timespan=4,
                      num_examples=12, max_objects=3)
  sizes = {s: provider.get('synth', data, split=s).get_dataset_size()
           for s in ('train', 'valid', 'test')}
  assert sizes == {'train': 12, 'valid': 8, 'test': 8}
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  want = SyntheticDataset(8, 32, 32, 4, seed=4, max_objects=3)
  got = provider.get('synth', data.to_dict(), split='valid')
  np.testing.assert_array_equal(got.x, want.x)
  batch = got.get_batch([1, 3], timespan=4, variables={'x', 's_gt'})
  assert sorted(batch) == ['s_gt', 'x']
  with pytest.raises(FileNotFoundError, match='cityscapes'):
    provider.get('cityscapes', data)
  with pytest.raises(FileNotFoundError, match='setup_dataset'):
    provider.get('cvppp', data.replace(folder='no/such/folder'))
