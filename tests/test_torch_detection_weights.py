"""Weights carried into the PyTorch port: `load_jax_params` lays a flax leaf
out by the kind of layer it belongs to, and the pretrained importers
(torchvision state dict, Detectron pkl, Keras h5) and `graft_backbone`
yield the port's state dicts directly.

The importers are held against a torchvision-style bottleneck ResNet built
here from `torch.nn`, with raw BatchNorm statistics: imported into the
port's `ResNet(norm='affine')` it must reproduce the source network's
activations."""
import pickle

import numpy as np
import pytest
import torch
import torch.nn as tnn

from depth_estimation_torch.models.detection.backbone import ResNet
from depth_estimation_torch.models.detection.rcnn import MaskRCNN
from depth_estimation_torch.utils import weights as W

BLOCKS, WIDTH = (1, 1, 1, 1), 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    test workers at once, and these small float64 runs gain little from
    more (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_ndim_rule(module, tree):
    """The layout rule `load_jax_params` had before: a four-dimensional
    leaf is an HWIO kernel, everything else is copied as it is."""
    flat = W._flat_jax_tree(tree)
    with torch.no_grad():
        for name, p in module.named_parameters():
            a = flat[name]
            p.copy_(torch.as_tensor(np.array(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)))
    return module


class _Square(tnn.Module):
    """A 2×2 stride-2 transposed conv, a 3×3 conv and a dense layer, all
    6 → 6, in the flax tree's names; NHWC in and out."""

    def __init__(self):
        super().__init__()
        self.ConvTranspose_0 = tnn.ConvTranspose2d(6, 6, 2, stride=2)
        self.Conv_0 = tnn.Conv2d(6, 6, 3, padding=1)
        self.Dense_0 = tnn.Linear(6, 6)

    def forward(self, x):
        y = self.Conv_0(self.ConvTranspose_0(x.permute(0, 3, 1, 2)))
        return self.Dense_0(y.permute(0, 2, 3, 1))


def test_square_dense_and_conv_transpose_load_by_layer_kind():
    """Square layers pass any shape check, so only the layer kind can say
    that a Dense kernel is transposed and a ConvTranspose kernel flipped."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    class Square(nn.Module):
        @nn.compact
        def __call__(self, x):
            y = nn.ConvTranspose(6, (2, 2), strides=(2, 2))(x)
            return nn.Dense(6)(nn.Conv(6, (3, 3))(y))

    x = np.random.RandomState(0).randn(1, 5, 4, 6)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          Square().init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(Square().apply(params, jnp.asarray(x)))
    port = W.load_jax_params(_Square().double(), params, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, rtol=1e-12, atol=1e-12)
        old = _old_ndim_rule(_Square().double(), params)(torch.from_numpy(x)).numpy()
    assert np.abs(old - want).max() > 1e-2  # the old rule fails this test


def test_existing_loads_are_unchanged():
    """VGG16Features, FeatureCNN and the refiner's raw conv parameters
    (`JAX_LAYOUTS`) load bit for bit as under the old rule."""
    import jax
    import jax.numpy as jnp

    from depth_estimation_torch.models.features import FeatureCNN, VGG16Features
    from depth_estimation_torch.models.refiner import CRFWithUncertainty
    from depth_estimation_tpu.models.features import FeatureCNN as JFeatureCNN
    from depth_estimation_tpu.models.features import VGG16Features as JVGG16Features
    from depth_estimation_tpu.models.refiner import uncertainty_init

    img = jnp.zeros((16, 16, 3))
    trees = [(lambda: VGG16Features(device="cpu"), JVGG16Features().init(jax.random.PRNGKey(0), img)),
             (lambda: FeatureCNN(out_dim=8, widths=(8, 8), device="cpu"),
              JFeatureCNN(out_dim=8, widths=(8, 8)).init(jax.random.PRNGKey(1), img)),
             (lambda: CRFWithUncertainty(d_in=8, device="cpu"),
              uncertainty_init(jax.random.PRNGKey(2), d_in=8))]
    for make, tree in trees:
        tree = jax.tree.map(np.asarray, tree)
        new, old = W.load_jax_params(make(), tree, device="cpu"), _old_ndim_rule(make(), tree)
        for (k, a), (_, b) in zip(new.state_dict().items(), old.state_dict().items()):
            assert torch.equal(a, b), k


class TorchBottleneck(tnn.Module):
    def __init__(self, cin, width, stride, stride_1x1=False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        self.conv1 = tnn.Conv2d(cin, width, 1, stride=s1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride=s3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(width * 4)
        self.downsample = None
        if cin != width * 4 or stride != 1:
            self.downsample = tnn.Sequential(tnn.Conv2d(cin, width * 4, 1, stride=stride, bias=False),
                                             tnn.BatchNorm2d(width * 4))

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + r)


class TorchResNet(tnn.Module):
    """torchvision's ResNet layout and names, at a small width."""

    def __init__(self, stride_1x1=False, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.conv1 = tnn.Conv2d(3, WIDTH, 7, stride=2, padding=3, bias=False)
        self.bn1 = tnn.BatchNorm2d(WIDTH)
        cin, width = WIDTH, WIDTH
        for s, n in enumerate(BLOCKS):
            stage = []
            for j in range(n):
                stage.append(TorchBottleneck(cin, width, 1 if s == 0 or j else 2, stride_1x1))
                cin = width * 4
            setattr(self, f"layer{s + 1}", tnn.Sequential(*stage))
            width *= 2
        with torch.no_grad():  # raw statistics, so the folding is exercised
            for m in self.modules():
                if isinstance(m, tnn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.5)
                    m.running_var.uniform_(0.5, 2.0)
                    m.weight.normal_(1.0, 0.2)
                    m.bias.normal_(0, 0.2)
        self.eval()

    def forward(self, x):
        y = torch.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for s in range(len(BLOCKS)):
            y = getattr(self, f"layer{s + 1}")(y)
            feats.append(y)
        return feats

    def numpy_state(self):
        return {k: v.detach().numpy() for k, v in self.state_dict().items()}


def _imported(sd, source):
    kw = W.resnet_import_kwargs(source)
    net = ResNet(BLOCKS, base_width=WIDTH, norm=kw["norm"], stride_1x1=kw["stride_1x1"]).eval()
    net.load_state_dict(sd)
    return net


@pytest.mark.parametrize("stride_1x1", [False, True])
def test_torch_import_reproduces_the_network(stride_1x1):
    src = TorchResNet(stride_1x1, seed=int(stride_1x1))
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 33, 41).astype(np.float32))
    sd = W.torch_resnet_params(src.numpy_state(), blocks=BLOCKS)
    with torch.no_grad():
        want = src(x)
        got = _imported(sd, "detectron" if stride_1x1 else "torch")(x)
        other = _imported(sd, "torch" if stride_1x1 else "detectron")(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert not torch.allclose(other[-1], want[-1], atol=1e-3)  # the stride flag matters


def test_importers_agree_with_each_other_and_with_jax(tmp_path):
    import h5py

    from depth_estimation_tpu.utils import weights as JW

    sd = TorchResNet().numpy_state()
    want = W.torch_resnet_params(sd, blocks=BLOCKS)
    # the same network as pre-folded Detectron blobs ...
    blobs = {"conv1_w": sd["conv1.weight"]}
    blobs["res_conv1_bn_s"], blobs["res_conv1_bn_b"] = W.fold_batchnorm(
        *(sd[f"bn1.{k}"] for k in ("weight", "bias", "running_mean", "running_var")))
    # ... and as Matterport Keras layers (HWIO kernels, raw statistics)
    with h5py.File(tmp_path / "mask_rcnn.h5", "w") as f:
        def put(layer, **leaves):
            g = f.require_group(layer)
            for name, arr in leaves.items():
                g.create_dataset(f"{name}:0", data=np.asarray(arr))

        def put_bn(layer, p):
            put(layer, gamma=sd[f"{p}.weight"], beta=sd[f"{p}.bias"],
                moving_mean=sd[f"{p}.running_mean"], moving_variance=sd[f"{p}.running_var"])

        put("conv1", kernel=sd["conv1.weight"].transpose(2, 3, 1, 0))
        put_bn("bn_conv1", "bn1")
        for stage, n in enumerate(BLOCKS):
            for j in range(n):
                tp, dp = f"layer{stage + 1}.{j}", f"res{stage + 2}_{j}_branch"
                kp = f"{stage + 2}{chr(ord('a') + j)}_branch"
                convs = [(f"{tp}.conv{i}", f"{tp}.bn{i}", c) for i, c in zip((1, 2, 3), "abc")]
                if f"{tp}.downsample.0.weight" in sd:
                    convs.append((f"{tp}.downsample.0", f"{tp}.downsample.1", "1"))
                for conv, bn, c in convs:
                    suffix = f"2{c}" if c != "1" else "1"
                    blobs[f"{dp}{suffix}_w"] = sd[f"{conv}.weight"]
                    blobs[f"{dp}{suffix}_bn_s"], blobs[f"{dp}{suffix}_bn_b"] = W.fold_batchnorm(
                        *(sd[f"{bn}.{k}"] for k in ("weight", "bias", "running_mean", "running_var")))
                    put(f"res{kp}{suffix}", kernel=sd[f"{conv}.weight"].transpose(2, 3, 1, 0))
                    put_bn(f"bn{kp}{suffix}", bn)
    with open(tmp_path / "model_final.pkl", "wb") as fp:
        pickle.dump({"blobs": blobs}, fp)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "r.pt")

    got = {"detectron": W.detectron_resnet_params(W.load_detectron_pkl(tmp_path / "model_final.pkl"),
                                                  blocks=BLOCKS),
           "keras": W.keras_resnet_params(W.load_keras_h5(tmp_path / "mask_rcnn.h5"),
                                          blocks=BLOCKS, eps=1e-5),
           "torch file": W.torch_resnet_params(W.load_torch_state_dict(tmp_path / "r.pt"),
                                               blocks=BLOCKS)}
    jax_tree = {"params": JW.torch_resnet_params(sd, blocks=BLOCKS)}
    got["JAX importer"] = W.state_dict_from_jax(ResNet(BLOCKS, WIDTH, norm="affine"), jax_tree)
    for name, g in got.items():
        assert set(g) == set(want), name
        for k in want:
            torch.testing.assert_close(g[k], want[k], rtol=1e-5, atol=1e-6, msg=f"{name}: {k}")
    assert W.resnet_import_kwargs("keras") == JW.resnet_import_kwargs("keras")
    with pytest.raises(ValueError):
        W.resnet_import_kwargs("caffe")


def test_vgg16_import_from_torchvision_names():
    from depth_estimation_torch.models.features import VGG16Features
    from depth_estimation_tpu.utils.weights import torch_vgg16_params

    rs = np.random.RandomState(0)
    widths = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
              (256, 512), (512, 512), (512, 512)]
    sd = {}
    for i, (cin, cout) in zip([0, 2, 5, 7, 10, 12, 14, 17, 19, 21], widths):
        sd[f"features.{i}.weight"] = rs.randn(cout, cin, 3, 3).astype(np.float32) * 0.05
        sd[f"features.{i}.bias"] = rs.randn(cout).astype(np.float32) * 0.01
    got = W.torch_vgg16_params(sd)
    net = VGG16Features(device="cpu")
    net.load_state_dict(got)
    want = W.state_dict_from_jax(net, torch_vgg16_params(sd))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_graft_backbone_into_maskrcnn():
    sd = W.torch_resnet_params(TorchResNet().numpy_state(), blocks=BLOCKS)
    kw = dict(num_classes=4, blocks=BLOCKS, fpn_dim=16, num_proposals=8, num_detections=4,
              score_thresh=-1.0, backbone_norm="affine", base_width=WIDTH, device="cpu",
              stride_1x1=W.resnet_import_kwargs("torch")["stride_1x1"])
    model = MaskRCNN(**kw)
    img = torch.from_numpy(np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    with torch.no_grad():
        before = model(img)["rpn_scores"]
        grafted = W.graft_backbone(model.state_dict(), sd)
        model.load_state_dict(grafted)
        out = model(img)
    assert torch.isfinite(out["boxes"]).all()
    assert not torch.allclose(out["rpn_scores"], before)
    for k, v in grafted.items():
        body = k.startswith("ResNetFPN_0.ResNet_0.")
        assert torch.equal(v, sd[k[len("ResNetFPN_0.ResNet_0."):]] if body else model.state_dict()[k])
    wide = MaskRCNN(**{**kw, "base_width": WIDTH * 2})
    with pytest.raises(ValueError, match="does not match"):
        W.graft_backbone(wide.state_dict(), sd)
