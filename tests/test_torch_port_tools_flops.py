"""unite_torch.tools.flops against tools/flops.py, on the CPU.

For each of the four default models at ``--input-size 32 --frames 2`` (the
UMT factories pin 224², so they run 2 x 196 patches and 78 visible
tokens):

* the parameter count equals JAX's ``model_cost`` exactly (the same
  modules);
* the counted forward FLOPs lie within [0.975, 1.0] of XLA's count of the
  JAX model on the same inputs. XLA also counts the elementwise work
  (softmax, LayerNorm, GELU, residual adds) that ``FlopCounterMode``
  leaves out: that is 0.3-1.7% at these shapes, while one block left out
  or a gather over the wrong token count moves the ratio by several
  percent;
* the counted FLOPs lie within 1% of ``unite_tpu.utils.flops.vit_flops``
  (the matrix products only), applied to each model's tokens: all patches
  for the ViT, the visible tokens plus the CLIP-alignment decoders for the
  masked-gather models, and per frame with a class token and the
  projection of each tap for CLIP.
"""

import pytest

from tests.test_torch_port_tools import jax_tool, one_thread  # noqa: F401
from unite_torch.tools import flops
from unite_tpu.models.adaptation import AdaptationVisionTransformer
from unite_tpu.models.clip import CLIPVisionTransformer
from unite_tpu.models.pretrain_umt import PretrainUMT
from unite_tpu.utils.flops import vit_flops

FRAMES, SIZE, RATIO = 2, 32, 0.8
DIM, CLIP_DIM = 768, 512  # ViT-B width; the CLIP-B/16 embedding width


def closed_form(name: str) -> int:
    """Matmul FLOPs of one forward of ``name`` at the test geometry."""
    if name == "vit_base_patch16_224":
        return vit_flops(FRAMES * (SIZE // 16) ** 2, num_classes=12)
    if name == "clip_b16":
        # frames fold into the batch: each runs a class token and its
        # patches (no patch embedding for the class token), and each of
        # the tapped blocks projects its patch tokens to CLIP_DIM
        patches = (SIZE // 16) ** 2
        taps = len(CLIPVisionTransformer.return_index)
        per_frame = vit_flops(patches + 1) - 2 * DIM * DIM
        return FRAMES * (per_frame + taps * 2 * patches * DIM * CLIP_DIM)
    # the UMT factories pin 224²; the encoder and one decoder per tapped
    # layer run on the visible tokens only
    n_vis = int(round(FRAMES * 14 * 14 * (1.0 - RATIO)))
    decoders = (len(AdaptationVisionTransformer.clip_return_layers)
                if name.startswith("adaptation_")
                else PretrainUMT.clip_return_layer)
    return vit_flops(n_vis) + decoders * 2 * n_vis * DIM * CLIP_DIM


@pytest.mark.parametrize("name", flops.DEFAULT_MODELS)
def test_parameters_equal_the_jax_tool(name):
    jtool = jax_tool("flops")
    assert flops.DEFAULT_MODELS == jtool.DEFAULT_MODELS
    ref_params, ref_flops, _ = jtool.model_cost(name, 1, FRAMES, 1, SIZE,
                                                RATIO)
    n_params, counted = flops.model_cost(name, 1, FRAMES, 1, SIZE, RATIO)
    assert n_params == ref_params
    assert 0.975 * ref_flops <= counted <= ref_flops, (counted, ref_flops)
    closed = closed_form(name)
    assert abs(counted - closed) <= 0.01 * closed, (counted, closed)


def test_table_rows(capsys):
    lines = flops.main(["clip_b16", "--input-size", "32", "--frames", "2"])
    assert capsys.readouterr().out.splitlines() == lines
    assert lines[1].split() == ["model", "params(M)", "GFLOPs"]
    row = lines[2].split()
    assert row[0] == "clip_b16" and 80 < float(row[1]) < 90
    assert float(row[2]) == pytest.approx(closed_form("clip_b16") / 1e9,
                                          abs=0.005)
