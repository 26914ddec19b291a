"""Host-side state of the port equals the JAX package's exactly: token ids,
compiled world tables, the unpadded device feature table, the view
location embeddings and the angle features."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.utils import angles as t_angles
from curriculum_learning_for_vln_torch.utils import config as t_config
from curriculum_learning_for_vln_torch.utils import tokenizer as t_tok
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_torch.world import synthetic as t_synth
from curriculum_learning_for_vln_tpu.utils import angles as j_angles
from curriculum_learning_for_vln_tpu.utils import config as j_config
from curriculum_learning_for_vln_tpu.utils import tokenizer as j_tok
from curriculum_learning_for_vln_tpu.world import compiler as j_compiler
from curriculum_learning_for_vln_tpu.world import synthetic as j_synth

torch.set_num_threads(2)

TABLES = ("scan_offset", "node_scan", "node_local", "pos", "cand_next", "cand_valid",
          "cand_heading", "cand_elev", "cand_view", "n_cands", "dist", "next_hop", "features")


@pytest.fixture(scope="module")
def worlds():
    out = []
    for synth, comp in ((j_synth, j_compiler), (t_synth, t_compiler)):
        graphs = synth.make_world_graphs(num_scans=3, nodes_per_scan=24, seed=7)
        kwargs = {"use_native": False} if comp is j_compiler else {}
        world = comp.compile_world(graphs, max_candidates=16, **kwargs)
        comp.attach_synthetic_features(world, feature_dim=64)
        out.append((world, synth.make_r2r_dataset(graphs, num_paths=40, seed=3)))
    return out


def test_tokenizer_ids_identical(worlds):
    (_, data_j), (_, data_t) = worlds
    assert data_j == data_t
    vocab_j = j_tok.read_vocab("assets/train_vocab.txt")
    vocab_t = t_tok.read_vocab("assets/train_vocab.txt")
    assert vocab_j == vocab_t and len(vocab_t) == 992
    for vocab in (vocab_t, t_tok.build_vocab(data_t, min_count=1)):
        tj, tt = j_tok.Tokenizer(vocab, encoding_length=24), t_tok.Tokenizer(vocab, encoding_length=24)
        for item in data_t:
            for instr in item["instructions"]:
                ej, et = tj.encode_sentence(instr), tt.encode_sentence(instr)
                assert (ej is None) == (et is None)
                if et is not None:
                    np.testing.assert_array_equal(ej[0], et[0])
                    assert ej[1] == et[1]


def test_compiled_tables_equal(worlds):
    (wj, _), (wt, _) = worlds
    assert wj.scan_ids == wt.scan_ids and wj.node_ids == wt.node_ids
    for name in TABLES:
        a, b = getattr(wj, name), getattr(wt, name)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_device_tables_unpadded(worlds, precision):
    (wj, _), (wt, _) = worlds
    tj = wj.device_tables(precision)
    tt = wt.device_tables(precision, device="cpu")
    assert tj.features.shape[1] == 40 and tuple(tt.features.shape[1:]) == (36, 64)
    assert tt.features.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    np.testing.assert_array_equal(tt.features.float().numpy(),
                                  np.asarray(tj.features[:, :36].astype(jnp.float32)))
    for name in ("cand_next", "cand_valid", "cand_view", "n_cands", "dist", "next_hop",
                 "cand_heading", "cand_elev", "node_local", "loc_embed"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)),
                                      err_msg=name)


def test_angles_equal():
    np.testing.assert_array_equal(t_angles.all_loc_embeddings(), j_angles.all_loc_embeddings())
    rng = np.random.default_rng(0)
    h = rng.uniform(-7, 7, (5, 16)).astype(np.float32)
    e = rng.uniform(-1, 1, (5, 16)).astype(np.float32)
    got = t_angles.make_angle_feat(torch.from_numpy(h), torch.from_numpy(e)).numpy()
    want = np.asarray(j_angles.make_angle_feat(jnp.asarray(h), jnp.asarray(e)))
    assert got.shape == (5, 16, 128)
    # sin/cos of the same f32 angles in two libraries: a few ulps apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_config_loads_repo_yamls():
    for path in ("configs/envdrop/envdrop_config.yaml", "configs/envdrop/envdrop_cl_config.yaml"):
        cj, ct = j_config.get_cfg_defaults(), t_config.get_cfg_defaults()
        cj.merge_from_file(path)
        ct.merge_from_file(path)
        assert ct.dump() == cj.dump(), path
    assert ct.TPU.PRECISION in ("bf16", "f32")
    assert ct.MODEL.ENVDROP.HIDDEN_SIZE == 512


def test_device_tables_default_to_cuda(worlds):
    (_, _), (wt, _) = worlds
    if torch.cuda.is_available():
        assert wt.device_tables("f32").features.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            wt.device_tables("f32")
