"""The model FLOPs against hand counts at tiny sizes."""

import torch

import flops


def test_counter_on_products():
    lin = torch.nn.Linear(8, 16, bias=False)
    conv = torch.nn.Conv2d(3, 4, 2, stride=2, bias=False)
    x, img = torch.randn(5, 8), torch.randn(1, 3, 4, 4)
    _, n = flops.count_flops(lambda: (lin(x), conv(img)))
    assert n == 2 * 5 * 8 * 16 + 2 * (4 * 2 * 2) * (3 * 2 * 2)


def test_vit_by_hand():
    # 8 px tiles of 4 px patches: 2 x 2 patches + class = 5 tokens, width 4,
    # one layer, MLP 8; shuffle 0.5 -> 1 token of 16 channels; output 6
    L, w = 5, 4
    layer = 2 * L * (4 * w * w + 2 * w * 8) + 4 * L * L * w
    embed = 2 * 4 * w * 3 * 4 * 4
    proj = 2 * 1 * (16 * 6 + 6 * 6)
    assert flops.vit_flops(3, 8, 4, w, 1, 8, 6, 0.5) == 3 * (embed + layer + proj)


def test_llm_by_hand():
    # hidden 8 (2 heads of 4, 1 KV head), 1 layer, FFN 16, vocab 10;
    # 3 prompt tokens and 2 new tokens: 4 token forwards, 2 head rows
    proj = 2 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16)
    attn = 4 * 2 * 4 * (1 + 2 + 3 + 4)
    head = 2 * 8 * 10 * 2
    assert flops.llm_flops(3, 2, 8, 1, 2, 1, 16, 10) == 4 * proj + attn + head


def _tiny_grounding():
    from harness import load_json
    from test_bench_cpu_runs import GROUNDING

    return dict(load_json("configs", "vstgnet_vidstg_420.json")["cfg"], **GROUNDING)


def test_grounding_request_on_meta_counts_the_served_forward():
    from reference.vstg.serve import ground
    from vstg_common import reference_model

    values = _tiny_grounding()
    model, _ = reference_model(values, 5, torch.device("cpu"))
    T, S = values["INPUT.TRAIN_SAMPLE_NUM"], values["INPUT.RESOLUTION"]
    frames = torch.randint(0, 256, (2 * T, S, S, 3), dtype=torch.uint8)
    _, real = flops.count_flops(lambda: ground(model.eval(), frames, 25.0, (360, 640),
                                               "the man rides a horse",
                                               values["INPUT.MAX_QUERY_LEN"]))
    assert flops.grounding_request_flops(values) == real > 0


def test_grounding_step_on_meta_counts_the_reference_step():
    from reference.vstg.containers import TextBatch, VideoBatch, normalize_uint8_video
    from reference.vstg.dropout import DropoutRng
    from reference.vstg.loss import build_loss, build_weight_dict
    from vstg_common import reference_cfg, reference_model

    values = _tiny_grounding()
    T, S, L = 4, 64, values["INPUT.MAX_QUERY_LEN"]
    g = torch.Generator().manual_seed(1)
    video = VideoBatch(torch.randint(0, 256, (1, T, S, S, 3), generator=g, dtype=torch.uint8),
                       torch.ones(1, S, S, dtype=torch.bool), torch.ones(1, T, dtype=torch.bool))
    text = TextBatch(torch.randint(3, 50, (1, L), generator=g), torch.ones(1, L, dtype=torch.bool))
    targets = {"boxes": torch.rand(1, T, 4, generator=g) * 0.5 + 0.25,
               "actioness": torch.ones(1, T), "time_mask": torch.ones(1, T, dtype=torch.bool),
               "sted": torch.tensor([[1, 3]]), "attr_labels": torch.zeros(1, 20),
               "verb_labels": torch.zeros(1, 34)}
    model, _ = reference_model(values, 5, torch.device("cpu"))
    ns = reference_cfg(values)
    loss_fn, wd = build_loss(ns), build_weight_dict(ns)
    stats = (tuple(values["INPUT.PIXEL_MEAN"]), tuple(values["INPUT.PIXEL_STD"]))

    def step():
        out = model.train()(normalize_uint8_video(video, stats, dtype=torch.float32), text,
                            train=True, rng=DropoutRng(3, "cpu"))
        ls = loss_fn(out, targets)
        sum(ls[n] * wd[n] for n in ls if n in wd).backward()

    _, real = flops.count_flops(step)
    assert flops.grounding_step_flops(values, (video, text, targets)) == real > 0


def test_mfu_readers_read_the_trace_alone():
    from types import SimpleNamespace

    from harness import TraceData, load_module

    values = _tiny_grounding()
    ctx = SimpleNamespace(cfg_values=values, params={})
    k2 = {"window_attn_sm90_kernel<1, false>": [2 * values["MODEL.VSTG.ENC_LAYERS"], 0.1]}
    serve = load_module("metrics", "mfu.serve")
    assert serve.read(TraceData(2.0, 1.0, 0, {}, [], []), ctx, {}) is None
    share = serve.read(TraceData(2.0, 1.0, 0, k2, [], []), ctx, {})
    want = 100.0 * 2 * flops.grounding_request_flops(values) / 2.0 / 989e12
    assert abs(share - want) <= 1e-9 * want
    train = load_module("metrics", "mfu.train")
    assert train.read(TraceData(2.0, 1.0, 0, {}, [], [], {"steps": 3}), ctx, {}) is None
