"""CNN architecture zoo — the port's own copy of ``repro.models.cnn_zoo``
(pure Python, kept identical so both packages build the same specs).

Conv-layer configurations of the networks the paper
profiles (Table 7 pool) and optimises (§4.3: AlexNet, VGG-11/19, GoogLeNet,
ResNet-18/34).

A network is a DAG over conv layers plus *join* nodes (concat / residual-add).
Join nodes are virtual PBQP nodes with one choice per data layout and zero
node cost; they keep branch/merge degrees small so the PBQP reduction solver
stays exact on inception-style modules (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    k: int      # kernels (output channels)
    c: int      # input channels
    im: int     # input spatial size (square)
    s: int      # stride
    f: int      # kernel size (square)

    @property
    def out_im(self) -> int:
        return (self.im - self.f) // self.s + 1

    @property
    def config(self) -> Tuple[int, int, int, int, int]:
        return (self.k, self.c, self.im, self.s, self.f)


@dataclasses.dataclass(frozen=True)
class JoinNode:
    """Virtual concat/add node; carries the tensor shape it produces."""
    name: str
    kind: str   # "concat" | "add"
    c: int
    im: int


@dataclasses.dataclass(frozen=True)
class EltwiseLayer:
    """Elementwise consumer (bias add / ReLU) — a fusion target for the plan
    compiler's epilogue pass (DESIGN.md §13.2). Like joins, eltwise nodes
    are virtual PBQP nodes with one choice per data layout; ``kind="bias"``
    carries a learned (c,) weight vector."""
    name: str
    kind: str   # "relu" | "bias"
    c: int
    im: int     # spatial size it produces (same as its producer's output)


Node = Union[ConvLayer, JoinNode, EltwiseLayer]


@dataclasses.dataclass
class CNNSpec:
    name: str
    nodes: List[Node]
    edges: List[Tuple[int, int]]          # (producer idx, consumer idx)

    @property
    def conv_layers(self) -> List[ConvLayer]:
        return [n for n in self.nodes if isinstance(n, ConvLayer)]

    def triplets(self) -> List[Tuple[int, int, int]]:
        return sorted({(l.c, l.k, l.im) for l in self.conv_layers})


class _Builder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []
        self.edges: List[Tuple[int, int]] = []

    def conv(self, k, c, im, s, f, prev: Union[int, None, Sequence[int]] = "last", tag="") -> int:
        idx = len(self.nodes)
        self.nodes.append(ConvLayer(f"{self.name}/{tag or 'conv'}{idx}", k, c, im, s, f))
        self._link(prev, idx)
        return idx

    def eltwise(self, kind, c, im, prev: Union[int, None, Sequence[int]] = "last", tag="") -> int:
        idx = len(self.nodes)
        self.nodes.append(EltwiseLayer(f"{self.name}/{tag or kind}{idx}", kind, c, im))
        self._link(prev, idx)
        return idx

    def join(self, kind, c, im, inputs: Sequence[int], tag="") -> int:
        idx = len(self.nodes)
        self.nodes.append(JoinNode(f"{self.name}/{tag or kind}{idx}", kind, c, im))
        for i in inputs:
            self.edges.append((i, idx))
        return idx

    def _link(self, prev, idx):
        if prev is None:
            return
        if prev == "last":
            if idx > 0:
                self.edges.append((idx - 1, idx))
            return
        if isinstance(prev, int):
            self.edges.append((prev, idx))
        else:
            for p in prev:
                self.edges.append((p, idx))

    def build(self) -> CNNSpec:
        return CNNSpec(self.name, self.nodes, self.edges)


# ---------------------------------------------------------------------------
# Chain families
# ---------------------------------------------------------------------------

def alexnet() -> CNNSpec:
    b = _Builder("alexnet")
    b.conv(64, 3, 224, 4, 11)
    b.conv(192, 64, 27, 1, 5)
    b.conv(384, 192, 13, 1, 3)
    b.conv(256, 384, 13, 1, 3)
    b.conv(256, 256, 13, 1, 3)
    return b.build()


_VGG_PLANS = {
    "vgg11": [(64, 1)], "vgg13": [(64, 2)], "vgg16": [(64, 2)], "vgg19": [(64, 2)],
}


def vgg(depth: int) -> CNNSpec:
    reps = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
            16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}[depth]
    chans = (64, 128, 256, 512, 512)
    ims = (224, 112, 56, 28, 14)
    b = _Builder(f"vgg{depth}")
    c_in = 3
    for (k, im, r) in zip(chans, ims, reps):
        for _ in range(r):
            b.conv(k, c_in, im, 1, 3)
            c_in = k
    return b.build()


def mobilenet_pointwise() -> CNNSpec:
    """MobileNet v1's standard convs + pointwise convs (depthwise omitted:
    grouped convs are outside the (k,c,im,s,f) parameterisation)."""
    b = _Builder("mobilenet")
    b.conv(32, 3, 224, 2, 3)
    plan = [(64, 32, 112), (128, 64, 56), (128, 128, 56), (256, 128, 28),
            (256, 256, 28), (512, 256, 14)] + [(512, 512, 14)] * 5 + \
           [(1024, 512, 7), (1024, 1024, 7)]
    for (k, c, im) in plan:
        b.conv(k, c, im, 1, 1)
    return b.build()


def squeezenet() -> CNNSpec:
    b = _Builder("squeezenet")
    prev = b.conv(96, 3, 224, 2, 7)
    fires = [(96, 16, 64, 64, 55), (128, 16, 64, 64, 55), (128, 32, 128, 128, 55),
             (256, 32, 128, 128, 27), (256, 48, 192, 192, 27), (384, 48, 192, 192, 27),
             (384, 64, 256, 256, 27), (512, 64, 256, 256, 13)]
    for (cin, sq, e1, e3, im) in fires:
        s = b.conv(sq, cin, im, 1, 1, prev=prev, tag="squeeze")
        a = b.conv(e1, sq, im, 1, 1, prev=s, tag="exp1")
        c = b.conv(e3, sq, im, 1, 3, prev=s, tag="exp3")
        prev = b.join("concat", e1 + e3, im - 2, [a, c])
    return b.build()


# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------

def resnet(depth: int) -> CNNSpec:
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[depth]
    bottleneck = depth >= 50
    b = _Builder(f"resnet{depth}")
    prev = b.conv(64, 3, 224, 2, 7)
    c_in, im = 64, 56
    widths = (64, 128, 256, 512)
    for stage, (width, nblk) in enumerate(zip(widths, blocks)):
        for blk in range(nblk):
            stride = 2 if (stage > 0 and blk == 0) else 1
            im_in = im * stride
            out_c = width * (4 if bottleneck else 1)
            if bottleneck:
                x1 = b.conv(width, c_in, im_in, 1, 1, prev=prev)
                x2 = b.conv(width, width, im_in, stride, 3, prev=x1)
                x3 = b.conv(out_c, width, im, 1, 1, prev=x2)
                tail = x3
            else:
                x1 = b.conv(width, c_in, im_in, stride, 3, prev=prev)
                x2 = b.conv(width, width, im, 1, 3, prev=x1)
                tail = x2
            if stride != 1 or c_in != out_c:
                sc = b.conv(out_c, c_in, im_in, stride, 1, prev=prev, tag="down")
                prev = b.join("add", out_c, im, [tail, sc])
            else:
                prev = b.join("add", out_c, im, [tail, prev])
            c_in = out_c
        im = im // 2 if stage < 3 else im
    return b.build()


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1)
# ---------------------------------------------------------------------------

_INCEPTION = [
    # (im, in_c, b1, b2red, b2, b3red, b3, b4)
    ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
    ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
    ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
    ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
    ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
    ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
    ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
    ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
    ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
]


def googlenet() -> CNNSpec:
    b = _Builder("googlenet")
    c1 = b.conv(64, 3, 224, 2, 7)
    c2 = b.conv(64, 64, 56, 1, 1, prev=c1)
    c3 = b.conv(192, 64, 56, 1, 3, prev=c2)
    prev = c3
    for (tag, im, cin, b1, b2r, b2k, b3r, b3k, b4) in _INCEPTION:
        n1 = b.conv(b1, cin, im, 1, 1, prev=prev, tag=f"{tag}.b1")
        n2a = b.conv(b2r, cin, im, 1, 1, prev=prev, tag=f"{tag}.b2r")
        n2 = b.conv(b2k, b2r, im, 1, 3, prev=n2a, tag=f"{tag}.b2")
        n3a = b.conv(b3r, cin, im, 1, 1, prev=prev, tag=f"{tag}.b3r")
        n3 = b.conv(b3k, b3r, im, 1, 5, prev=n3a, tag=f"{tag}.b3")
        n4 = b.conv(b4, cin, im, 1, 1, prev=prev, tag=f"{tag}.b4")
        prev = b.join("concat", b1 + b2k + b3k + b4, im, [n1, n2, n3, n4], tag=f"{tag}.cat")
    return b.build()


# ---------------------------------------------------------------------------
# DenseNet-121 (pool contributor)
# ---------------------------------------------------------------------------

def densenet121() -> CNNSpec:
    b = _Builder("densenet121")
    b.conv(64, 3, 224, 2, 7)
    growth = 32
    c_in = 64
    for im, nlayers in ((56, 6), (28, 12), (14, 24), (7, 16)):
        for i in range(nlayers):
            b.conv(128, c_in + growth * i, im, 1, 1, tag="bottleneck")
            b.conv(growth, 128, im, 1, 3, tag="dense")
        c_in = (c_in + growth * nlayers) // 2
        if im > 7:
            b.conv(c_in, c_in * 2, im, 1, 1, tag="transition")
    return b.build()


def shufflenet_v2() -> CNNSpec:
    """ShuffleNet v2 x1.0 pointwise/3x3 stages (grouped convs folded to
    their (k,c,im) shapes — pool contributor)."""
    b = _Builder("shufflenet_v2")
    b.conv(24, 3, 224, 2, 3)
    for (im, cin, cout, n) in ((28, 24, 116, 4), (14, 116, 232, 8), (7, 232, 464, 4)):
        for i in range(n):
            c = cin if i == 0 else cout
            b.conv(cout // 2, c, im, 1, 1, tag="pw1")
            b.conv(cout // 2, cout // 2, im, 1, 3, tag="dwish")
            b.conv(cout // 2, cout // 2, im, 1, 1, tag="pw2")
    b.conv(1024, 464, 7, 1, 1, tag="head")
    return b.build()


def edge_cnn() -> CNNSpec:
    """Small 32x32 edge-class CNN (the serve example's deployment target):
    two stages of squeeze-style concats and residual adds — every join
    topology, MobileNet-like depth, at a scale where per-layer dispatch
    overhead, not FLOPs, dominates the interpreted executor."""
    b = _Builder("edge_cnn")
    c1 = b.conv(16, 3, 32, 1, 3)
    c2 = b.conv(32, 16, 30, 1, 3, prev=c1)
    a1 = b.conv(16, 32, 28, 1, 1, prev=c2, tag="exp1")
    a3 = b.conv(16, 32, 28, 1, 3, prev=c2, tag="exp3")
    cat = b.join("concat", 32, 26, [a1, a3])
    d1 = b.conv(32, 32, 26, 1, 3, prev=cat)
    d2 = b.conv(32, 32, 24, 1, 3, prev=d1)
    sc = b.conv(32, 32, 26, 1, 1, prev=cat, tag="down")
    add = b.join("add", 32, 22, [d2, sc])
    e1 = b.conv(48, 32, 22, 2, 3, prev=add)
    e2 = b.conv(48, 48, 10, 1, 3, prev=e1)
    f1 = b.conv(64, 48, 8, 1, 1, prev=e2, tag="exp1")
    f3 = b.conv(64, 48, 8, 1, 3, prev=e2, tag="exp3")
    cat2 = b.join("concat", 128, 6, [f1, f3])
    g1 = b.conv(64, 128, 6, 1, 3, prev=cat2)
    sc2 = b.conv(64, 128, 6, 1, 1, prev=cat2, tag="down")
    add2 = b.join("add", 64, 4, [g1, sc2])
    b.conv(96, 64, 4, 1, 3, prev=add2, tag="head")
    return b.build()


def inception_v3_pool() -> CNNSpec:
    """Inception-v3 stem + representative mixed-block convs (pool contributor)."""
    b = _Builder("inception_v3")
    b.conv(32, 3, 299, 2, 3)
    b.conv(32, 32, 149, 1, 3)
    b.conv(64, 32, 147, 1, 3)
    b.conv(80, 64, 73, 1, 1)
    b.conv(192, 80, 73, 1, 3)
    for (im, cin, outs) in ((35, 192, (64, 48, 64, 96)), (35, 256, (64, 48, 64, 96)),
                            (17, 768, (192, 128, 192, 192)), (8, 1280, (320, 384, 448, 192))):
        prev = len(b.nodes) - 1
        tails = []
        for k in outs:
            tails.append(b.conv(k, cin, im, 1, 1, prev=prev))
        f = 5 if im == 35 else 3
        tails.append(b.conv(outs[1], outs[1], im, 1, f, prev=tails[1]))
        b.join("concat", sum(outs) + outs[1], im - (f - 1), tails)
    return b.build()


def resnet_deep_pool(depth: int) -> CNNSpec:
    """ResNet-101/152 bottleneck conv shapes (pool contributors)."""
    blocks = {101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    b = _Builder(f"resnet{depth}")
    b.conv(64, 3, 224, 2, 7)
    c_in, im = 64, 56
    for stage, (width, nblk) in enumerate(zip((64, 128, 256, 512), blocks)):
        for blk in range(min(nblk, 4)):   # shapes repeat; 4 reps cover the triplets
            stride = 2 if (stage > 0 and blk == 0) else 1
            b.conv(width, c_in, im * stride, 1, 1)
            b.conv(width, width, im * stride, stride, 3)
            b.conv(width * 4, width, im, 1, 1)
            c_in = width * 4
        im = im // 2 if stage < 3 else im
    return b.build()


ZOO = {
    "alexnet": alexnet,
    "edge_cnn": edge_cnn,
    "vgg11": lambda: vgg(11),
    "vgg13": lambda: vgg(13),
    "vgg16": lambda: vgg(16),
    "vgg19": lambda: vgg(19),
    "resnet18": lambda: resnet(18),
    "resnet34": lambda: resnet(34),
    "resnet50": lambda: resnet(50),
    "googlenet": googlenet,
    "squeezenet": squeezenet,
    "mobilenet": mobilenet_pointwise,
    "densenet121": densenet121,
    "shufflenet_v2": shufflenet_v2,
    "inception_v3": inception_v3_pool,
    "resnet101": lambda: resnet_deep_pool(101),
    "resnet152": lambda: resnet_deep_pool(152),
}

# the six networks the paper optimises (§4.3)
PAPER_SELECTION_NETS = ("alexnet", "vgg11", "vgg19", "googlenet", "resnet18", "resnet34")

# zoo entries whose DAGs are channel-consistent end to end and can be run by
# the executor (the rest are triplet *pool contributors*: chains of conv
# shapes whose grouped/concat plumbing is folded away, profile-only)
EXECUTABLE_NETS = ("alexnet", "edge_cnn", "vgg11", "vgg13", "vgg16", "vgg19",
                   "resnet18", "resnet34", "resnet50", "googlenet",
                   "squeezenet", "mobilenet")


def get(name: str) -> CNNSpec:
    return ZOO[name]()


def pool_triplets() -> List[Tuple[int, int, int]]:
    """(c, k, im) triplets across the zoo — the paper's Table 7 pool
    ('475 unique triplets' from common architectures)."""
    trip = set()
    for fn in ZOO.values():
        trip.update(fn().triplets())
    return sorted(trip)
