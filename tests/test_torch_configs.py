"""The port's config registry exports what ``repro.configs`` exports
(``get_shape``, ``SHAPES``, the four shapes, ``channel_gain``,
``path_loss_db``, ``ASSIGNED``), with the same values: the cases of
tests/test_configs.py, run on both packages."""
import dataclasses

import pytest

import repro.configs as J
import repro_torch.configs as T

SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_get_shape_gives_repros_shape(name):
    got, want = T.get_shape(name), J.get_shape(name)
    assert got is T.SHAPES[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_shapes():
    S = T.SHAPES
    assert sorted(S) == sorted(J.SHAPES) == sorted(SHAPE_NAMES)
    assert S["train_4k"].seq_len == 4096 and S["train_4k"].global_batch == 256
    assert S["prefill_32k"].global_batch == 32
    assert S["decode_32k"].global_batch == 128
    assert S["long_500k"].seq_len == 524288 and S["long_500k"].kind == "decode"
    assert (T.TRAIN_4K, T.PREFILL_32K, T.DECODE_32K, T.LONG_500K) == tuple(
        S[n] for n in SHAPE_NAMES)


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown shape 'nope'"):
        T.get_shape("nope")
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        T.get_arch("nope")


def test_assigned_is_ported_and_repros_ten():
    assert T.ASSIGNED is T.PORTED
    assert {c.name for c in T.ASSIGNED} == {c.name for c in J.ASSIGNED}
    assert len(T.ASSIGNED) == 10


@pytest.mark.parametrize("d_m", [10.0, 50.0, 120.0, 400.0])
def test_channel_model_is_repros(d_m):
    assert T.path_loss_db(d_m / 1e3) == J.path_loss_db(d_m / 1e3)
    for shadow in (0.0, -3.5, 8.0):
        assert T.channel_gain(d_m, shadow) == J.channel_gain(d_m, shadow)


def test_every_name_is_exported():
    for name in ("get_shape", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
                 "LONG_500K", "channel_gain", "path_loss_db", "ASSIGNED"):
        assert name in T.__all__ and hasattr(T, name)
