"""The port's language models against the JAX package's in bfloat16
(``param_dtype = compute_dtype = "bfloat16"``), on the CPU, for all ten
reduced architectures: ``forward``, ``prefill`` and ``decode_step`` give
the reference's output and cache dtypes and shapes, and logits within the
tolerance below.  In bf16 the conv states and the mLSTM projections mix
bf16 activations with float32 weights, which ``torch.matmul`` refuses and
JAX promotes.  The float32 cases and the harness are in
``tests/test_torch_models.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import ALL_ARCHS, S, make_pair, np32, t2np

from repro_torch import convert as cv
from repro_torch import serving
from repro_torch.models import transformer as tf

# XLA fuses elementwise chains and rounds to bf16 once per fusion; ATen
# rounds after every op.  The reduced configs' attention is sharp (the
# reference's ``_dense`` scales wq by 1/sqrt(H)), so those one-ulp
# differences grow through the layers: the relative L2 error of the logits
# measured 0.001-0.103 across the ten archs.  A dtype or promotion fault
# gives O(1).  Logits are held to a relative L2 error of 0.2.
REL_L2 = 0.2


@pytest.fixture(scope="module")
def pairs():
    """Each architecture's bf16 reference outputs, computed once, on first use."""
    return functools.lru_cache(maxsize=None)(functools.partial(make_pair, dtype="bfloat16"))


def rel_l2(got: torch.Tensor, want) -> float:
    w = np32(want)
    return float(np.linalg.norm(t2np(got) - w) / np.linalg.norm(w))


def assert_like(pair, ref_tree, caches):
    """The reference's leaf names, shapes and dtypes; finite where it is."""
    _, want = cv.split_layers(pair.rcfg, ref_tree)
    assert len(want) == len(caches)
    for li, (w, g) in enumerate(zip(want, caches)):
        assert sorted(w) == sorted(g), li
        for name in w:
            assert tuple(g[name].shape) == w[name].shape, (li, name)
            assert cv.dtype_name(g[name].dtype) == cv.dtype_name(w[name].dtype), (li, name)
            np.testing.assert_array_equal(np.isfinite(t2np(g[name])),
                                          np.isfinite(np32(w[name])), err_msg=f"{li} {name}")


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_bf16_forward(pairs, aid):
    pair = pairs(aid)
    model = pair.model()
    assert {p.dtype for n, p in model.named_parameters() if n.endswith(("wq", "w_up", "w_x"))} \
        <= {torch.bfloat16}
    logits, aux = tf.forward(model, pair.cfg, pair.tensors(pair.ext))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert rel_l2(logits, pair.ref["logits"]) < REL_L2


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_bf16_prefill(pairs, aid):
    pair = pairs(aid)
    last, caches = serving.prefill(pair.model(), pair.cfg, pair.tensors(pair.batch))
    assert last.dtype == torch.float32
    assert rel_l2(last, pair.ref["last"]) < REL_L2
    assert_like(pair, pair.ref["caches"], caches)


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_bf16_decode(pairs, aid):
    """On the reference's grown bf16 caches, carried across."""
    pair = pairs(aid)
    caches = cv.lm_caches_from_tree(pair.cfg, pair.ref["grown"], device="cpu")
    logits, caches = serving.decode_step(pair.model(), pair.cfg, caches,
                                         pair.tensors(pair.inp), S)
    assert logits.dtype == torch.float32
    assert rel_l2(logits, pair.ref["dlogits"]) < REL_L2
    assert_like(pair, pair.ref["dcaches"], caches)
