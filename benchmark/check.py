"""The comparison that decides ``correct``.

The system under test (the program, or in the control the reference at a
lower precision) is followed stage by stage from its own state: each
stage of the reference takes the inputs that the system's stage took, and
its output is compared with the system's. GaussianFormer-2's lifter picks
its anchors by farthest-point sampling, where a last-bit difference in a
candidate changes every later pick, so a reference that ran end to end
from the images would not follow the same anchors; stage by stage it
does, and the lifter's whole output is compared row by row.

Frame cells: the towers (the FPN's maps), the lifter's tower and its
whole output (every anchor and instance feature), each operation of the
encoder (the spconvs apart: they run in bf16), how the stages are put
together (each stage's input against what the reference's composition
hands it from the system's own stage outputs), the head's probabilities
and labels, all of one frame of the timed window, and that every stage
ran. Train cells: the
same stages of the first step's forward (with the system's dropout
draws); the backward of each stage that the first step's backward ran
(each DCN of the towers, each encoder operation, the head), from the
arguments and the output's cotangent that the system's stage had; then
the reference follows the system's first steps (the traffic's
``checked``, or the cell's ``steps_followed``) from the same weights,
samples, anchors and draws: each step's loss and gradient norm, the first
step's gradient and the steps' change of each trained leaf, by the worst
leaf and by the median one.

A deformable aggregation's gaps (its output in ``encoder_rel``, its
anchors' rows of the arguments' gradients in ``encoder_grad_rel``) leave
out the anchors that have a key point at an image's edge
(``edge_anchors`` of the reference's aggregation): whether such a point
is seen turns on the last bits of its projection on either side.

Every number is a gap that should be small; ``correct`` holds when each
number that ``checks/<workload>.json`` names is at most its limit there.
The others are computed for ``readings.py``."""
from __future__ import annotations

import contextlib
import statistics

import torch

from .reference.precision import REFERENCE


def tree_map(fn, x):
    """``x`` (tensors in dicts, lists, tuples and named tuples) with ``fn``
    applied to each tensor, in the order of :func:`leaves`."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def leaves(x) -> list:
    out = []
    tree_map(out.append, x)
    return out


def rel(a, b) -> float:
    """max over the tensors of ``a`` and ``b`` (pairwise) of
    ||a - b|| / ||b||, in float64."""
    worst = 0.0
    for x, y in zip(leaves(a), leaves(b)):
        x, y = x.double(), y.double()
        den = torch.linalg.vector_norm(y).item()
        num = torch.linalg.vector_norm(x - y).item()
        worst = max(worst, num / den if den > 0 else num)
    return worst


def as_float(x):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t, x)


def detached(x):
    return tree_map(lambda t: t.detach(), x)


def snapshot(model):
    """:func:`detached`, with a copy of each tensor that shares a parameter
    of ``model``'s storage (a v1 anchor bank handed on as a view): the
    optimizer updates those in place after the step."""
    held = {p.untyped_storage().data_ptr() for p in model.parameters()}

    def one(t):
        t = t.detach()
        return t.clone() if t.untyped_storage().data_ptr() in held else t
    return lambda x: tree_map(one, x)


def moved(x, device):
    """``x`` (tensors in dicts, lists and tuples) on ``device``."""
    return tree_map(lambda t: t.to(device), x)


def head_outputs(o):
    """The supervised layers' outputs of a head's result: the program's
    dict, or the reference's (outputs, labels)."""
    return o["pred_occ"] if isinstance(o, dict) else o[0]


def encoder_order(model):
    enc = model.encoder
    return getattr(enc, "operation_order", None) or enc.order


def is_dcn(module) -> bool:
    return type(module).__name__ == "DeformConv2d"


class FrameCapture:
    """Forward hooks on a model with the program's module names (the
    program, or the reference in its place) that keep what each stage of
    one forward took and gave: the FPN's maps, the lifter tower's map,
    the encoder's arguments (the lifter's output and the maps as the
    encoder takes them), every encoder operation's arguments and output,
    the encoder's Gaussians, the head's input and its last output and
    labels. Hooks
    are on only inside ``with capture.on():``; with ``detach`` the tensors
    kept hold no autograd graph and outlive the step's update
    (:func:`snapshot`)."""

    def __init__(self, model, detach: bool = False):
        self.model = model
        self.keep = snapshot(model) if detach else (lambda x: x)
        self.data = {"ops": []}

    @contextlib.contextmanager
    def on(self):
        m = self.model
        keep = self.data

        def put(key, fn=lambda out: out):
            return lambda mod, args, out: keep.__setitem__(
                key, self.keep(fn(out)))

        def op(i):
            def hook(mod, args, out):
                keep["ops"].append((i, self.keep(args), self.keep(out)))
            return hook

        def head(mod, args, out):
            keep["head_in"] = self.keep(args[0])
            keep["head"] = self.keep(
                (out["pred_occ"][-1], out["final_occ"])
                if isinstance(out, dict) else (out[0][-1], out[1]))

        def encoder(mod, args, out):
            keep["enc_args"] = self.keep(args[:5])
            keep["anchor"] = keep["enc_args"][0]
            keep["preds"] = self.keep(out["representation"]
                                      if isinstance(out, dict) else out)

        hooks = [(m.img_neck, put("fpn")), (m.encoder, encoder),
                 (m.head, head)]
        if hasattr(m.lifter, "initialize_backbone"):
            hooks.append((m.lifter.initialize_backbone, put("lifter_feat")))
        hooks.append((m.encoder.anchor_encoder, op("embed")))
        for i, (name, layer) in enumerate(zip(encoder_order(m),
                                              m.encoder.layers)):
            if name not in ("identity", "add"):
                hooks.append((layer, op(i)))
        handles = [mod.register_forward_hook(h) for mod, h in hooks]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()


class GradCapture:
    """Hooks that keep, for each stage of one train step whose backward
    the reference follows (each DCN of the towers, by module name; each
    encoder operation, by its index in the order; ``"head"``), what the
    step's own backward took and gave there: the stage's arguments, the
    cotangent of each of its outputs and the gradient of each argument and
    parameter, by the tensor's place in :func:`leaves` and by the
    parameter's name. Each argument and output that takes part in the
    backward is handed on as a view of itself, so that what its hook
    reads comes from outside the stage alone (a refine's Gaussian shares
    tensors with its new anchor); the arithmetic is unchanged. A gradient
    the backward never gave is kept as missing (``needs``, ``params``)."""

    def __init__(self, model):
        self.stages = {"head": (model.head, head_outputs)}
        for i, (name, layer) in enumerate(zip(encoder_order(model),
                                              model.encoder.layers)):
            if name not in ("identity", "add"):
                self.stages[i] = (layer, lambda o: o)
        for name, mod in model.named_modules():
            if is_dcn(mod):
                self.stages[name] = (mod, lambda o: o)
        self.keep = snapshot(model)
        self.data = {}

    @contextlib.contextmanager
    def on(self):
        handles = []
        for key, (mod, select) in self.stages.items():
            rec = self.data.setdefault(key, {
                "arg_grad": {}, "out_grad": {}, "param_grad": {},
                "needs": set(), "params": set()})
            handles += [mod.register_forward_pre_hook(self._pre(rec)),
                        mod.register_forward_hook(self._post(rec, select))]
            for name, p in mod.named_parameters():
                if p.requires_grad:
                    rec["params"].add(name)
                    handles.append(p.register_hook(
                        self._keep(rec["param_grad"], name)))
        try:
            yield self
        finally:
            for h in handles:
                h.remove()

    @staticmethod
    def _keep(store, key):
        # a copy: a leaf's gradient may become its ``.grad``, which the
        # clipping then scales in place
        def hook(g):
            store[key] = g.detach().clone()
        return hook

    def _pre(self, rec):
        def pre(mod, args):
            count = [0]

            def swap(t):
                j = count[0]
                count[0] += 1
                if not t.requires_grad:
                    return t
                rec["needs"].add(j)
                v = t.view_as(t)
                v.register_hook(self._keep(rec["arg_grad"], j))
                return v
            args = tree_map(swap, args)
            rec["args"] = self.keep(args)
            return args
        return pre

    def _post(self, rec, select):
        def post(mod, args, out):
            out = tree_map(lambda t: t.view_as(t) if t.requires_grad
                           else t, out)
            for j, t in enumerate(leaves(select(out))):
                if t.requires_grad:
                    t.register_hook(self._keep(rec["out_grad"], j))
            return out
        return post


def stage_grads(fn, rec, params) -> tuple:
    """(``fn``'s output, {argument's place: gradient}, {parameter's name:
    gradient}): ``fn`` run on float copies of the arguments ``rec`` kept
    (:class:`GradCapture`), its outputs' cotangents the system's, and the
    gradient of each argument that the system's backward owed and of each
    of ``params`` that the system's stage had (zero where none flows)."""
    flat = []

    def leaf(t):
        x = t.detach().float() if t.is_floating_point() else t
        if len(flat) in rec["needs"]:
            x.requires_grad_()
        flat.append(x)
        return x
    args = tree_map(leaf, rec["args"])
    with torch.enable_grad():
        out = fn(args)
    outs = leaves(out)
    cot = sorted(rec["out_grad"])
    needs, names = sorted(rec["needs"]), sorted(rec["params"])
    wrt = [flat[j] for j in needs] + [params[k] for k in names]
    want = torch.autograd.grad([outs[j] for j in cot], wrt,
                               [rec["out_grad"][j].float() for j in cot],
                               allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w
            for w, x in zip(want, wrt)]
    return (out, dict(zip(needs, want[:len(needs)])),
            dict(zip(names, want[len(needs):])))


def grad_gaps(fn, rec, params, rows=None) -> tuple:
    """(``fn``'s output, {gradient: gap}): each gradient that
    :func:`stage_grads` gives (``arg<place>`` or the parameter's name)
    against the system's (one the system never gave counts as zero):
    ||got - want|| over the larger of ||want|| and the median gradient's
    ||want||. ``rows``: ([B, P] mask, argument places): of those
    arguments' gradients only the rows the mask keeps are compared."""
    out, args, prm = stage_grads(fn, rec, params)
    names = [f"arg{j}" for j in args] + list(prm)
    want = list(args.values()) + list(prm.values())
    got = ([rec["arg_grad"].get(j) for j in args]
           + [rec["param_grad"].get(k) for k in prm])
    got = [torch.zeros_like(w) if g is None else g
           for g, w in zip(got, want)]
    if rows is not None:
        mask, places = rows
        cut = [j in places for j in args] + [False] * len(prm)
        got = [g[mask.to(g.device)] if c else g for g, c in zip(got, cut)]
        want = [w[mask] if c else w for w, c in zip(want, cut)]
    return detached(out), dict(zip(names, _gaps(got, want)))


def vjp(fn, rec, params, rows=None) -> tuple:
    """(``fn``'s output, the largest of :func:`grad_gaps`)."""
    out, gaps = grad_gaps(fn, rec, params, rows)
    return out, max(gaps.values(), default=0.0)


def _gaps(got, want) -> list:
    norm = lambda t: torch.linalg.vector_norm(t.double()).item()  # noqa
    wn = [norm(w) for w in want]
    med = statistics.median(wn) if wn else 0.0
    return [norm(g.double().to(w.device) - w.double()) / d
            if (d := max(n, med)) > 0 else norm(g)
            for g, w, n in zip(got, want, wn)]


def rows_off(got, want) -> torch.Tensor:
    """[B, P] bool: the rows (anchors) of ``got`` that differ from
    ``want``'s by more than 1e-4 in some column."""
    return (got.float() - want).abs().amax(-1) > 1e-4


def wiring_gap(ref, cap) -> float:
    """How the system's stages are put together: the largest gap between
    what a stage took and what the reference's composition hands it when
    every encoder operation and anchor embedding gives the system's own
    output. It covers the maps (the FPN's output as the encoder takes
    them), each operation's arguments (the residual adds and the saves
    before them, the anchor after each refine and its embedding), the
    encoder's predictions and the head's input. Every value compared is
    moved or added as the program does it, so a sound system reads 0."""
    order = ref.encoder.order
    ops = {i: as_float((args, got)) for i, args, got in cap["ops"]
           if i != "embed"}
    embeds = [as_float((args[0], got)) for i, args, got in cap["ops"]
              if i == "embed"]
    anchor, feat, fmaps, proj, wh = as_float(cap["enc_args"])
    b, n = fmaps[0].shape[:2]
    worst = rel(fmaps, [f.float().permute(0, 2, 3, 1).reshape(
        b, n, *f.shape[2:4], -1) for f in cap["fpn"]])
    identity, preds, embed = None, [], None

    def embedding(k, anchor):
        if k >= len(embeds):
            return None, 0.0
        return embeds[k][1], rel(embeds[k][0], anchor)

    embed, gap = embedding(0, anchor)
    worst = max(worst, gap)
    for i, op in enumerate(order):
        if op == "identity":
            identity = feat
        elif op == "add":
            feat = feat + identity
        elif i in ops:
            args, got = ops[i]
            want = {"deformable": (feat, anchor, embed, fmaps, proj, wh),
                    "spconv": (feat, anchor),
                    "refine": (feat, anchor, embed)}.get(op, (feat,))
            worst = max(worst, rel(args[:len(want)], want))
            if op != "refine":
                feat = got
                continue
            anchor, g = got
            preds.append(g)
            if i != len(order) - 1:
                embed, gap = embedding(len(preds), anchor)
                worst = max(worst, gap)
    preds_got = as_float(cap["preds"])
    return max(worst, rel(preds_got, preds),
               rel(as_float(cap["head_in"]), preds_got))


#: the arguments of a deformable aggregation indexed by anchor: the
#: instance features, the anchors and their embedding
DEFORMABLE_ROWS = (0, 1, 2)


def check_frame(ref, cap, sample, draws, labels, enc_draws=None,
                grads=None) -> dict:
    """The gaps of one forward: ``cap`` the system's stages
    (:class:`FrameCapture`), ``sample`` and ``draws`` (the lifter's) its
    inputs, ``labels`` [B, N] the labels the timed path gave;
    ``enc_draws`` the encoder's dropout draws as the system made them, in
    order (a train step's forward); ``grads`` the first step's
    :class:`GradCapture` (a train step), whose encoder operations and
    head are followed backward too."""
    c = ref.c
    out = {}
    grads = grads or {}
    imgs = sample["imgs"]
    b, n = imgs.shape[:2]
    flat = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
    order = ref.encoder.order
    seen = {i for i, _, _ in cap["ops"]}
    missing = sum(1 for i, op in enumerate(order)
                  if op not in ("identity", "add") and i not in seen)
    missing += abs(sum(1 for i, _, _ in cap["ops"] if i == "embed")
                   - order.count("refine"))

    with torch.no_grad(), REFERENCE.matmul():
        maps = ref.img_neck(ref.img_backbone(flat))
        out["towers_rel"] = rel(as_float(cap["fpn"]), maps)
        del maps
        anchor, inst, fmaps, proj, wh = as_float(cap["enc_args"])
        if c["version"] == 2:
            lf = ref.lifter
            out["lifter_tower_rel"] = rel(
                cap["lifter_feat"].float(), lf.initialize_backbone(flat))
            feat = cap["lifter_feat"].float()
            logits = lf.logits(feat, b)
            origin, ray = lf.rays(sample["projection_mat"],
                                  sample["image_wh"], *logits.shape[2:4])
            xyz = lf.anchors_xyz(lf.candidates(logits, origin, ray, draws))
            want_anchor, want_inst = lf.representation(xyz)
        else:
            want_anchor, want_inst = ref.lifter.representation(b)
        out["anchors_off"] = float((rows_off(anchor, want_anchor)
                                    | rows_off(inst, want_inst))
                                   .sum().item())
        enc, spc, enc_g, spc_g = 0.0, 0.0, 0.0, 0.0
        enc_g_at = None
        replay = None if enc_draws is None else Replay(enc_draws).rand
        for i, args, got in cap["ops"]:
            op = "embed" if i == "embed" else order[i]
            kept = None
            if op == "deformable":
                # anchors with a key point at an image's edge are left out
                a = as_float(args)
                kept = ~ref.encoder.layers[i].edge_anchors(a[0], a[1],
                                                           a[4], a[5])
            if op == "embed":
                want = ref.encoder.anchor_encoder(as_float(args)[0])
            elif _ran(grads.get(i)):
                want, gaps = grad_gaps(
                    lambda a, i=i: ref.encoder.run_op(i, a, replay),
                    grads[i], dict(ref.encoder.layers[i]
                                   .named_parameters()),
                    None if kept is None else (kept, DEFORMABLE_ROWS))
                gap = max(gaps.values(), default=0.0)
                if op == "spconv":
                    spc_g = max(spc_g, gap)
                elif gap >= enc_g:
                    enc_g = gap
                    enc_g_at = f"{i} {op} {max(gaps, key=gaps.get)}"
            else:
                want = ref.encoder.run_op(i, as_float(args), replay)
            got = as_float(got)
            if kept is not None:
                got, want = got[kept], want[kept]
            if op == "spconv":
                spc = max(spc, rel(got, want))
            else:
                enc = max(enc, rel(got, want))
        out["encoder_rel"] = enc
        out["spconv_rel"] = spc
        out["wiring_rel"] = wiring_gap(ref, cap)
        outs, want_labels = ref.head(as_float(cap["preds"]),
                                     sample["occ_xyz"])
        out["head_rel"] = rel(cap["head"][0].float(), outs[-1])
        out["labels_off"] = (labels.to(want_labels.device).long()
                             != want_labels).float().mean().item()
        if grads:
            out["encoder_grad_rel"] = enc_g
            out["encoder_grad_worst"] = enc_g_at
            out["spconv_grad_rel"] = spc_g
            _, out["head_grad_rel"] = vjp(
                lambda a: ref.head(a[0], a[1], training=True)[0],
                grads["head"], dict(ref.head.named_parameters()))
            missing += sum(1 for i in seen | {"head"}
                           if i != "embed" and not _ran(grads.get(i)))
    out["stages_missing"] = float(missing)
    return out


def _ran(rec) -> bool:
    """Whether a stage's backward ran: its output got a cotangent."""
    return bool(rec and rec["out_grad"])


def leaf_gaps(got: dict, want: dict, names, scale=1.0) -> list:
    """Per leaf, | ||got|| * scale - ||want|| | over the larger of ||want||
    and the median leaf's ||want||."""
    gn = {k: torch.linalg.vector_norm(got[k].double()).item() * scale
          for k in names}
    wn = {k: torch.linalg.vector_norm(want[k].double()).item() for k in names}
    med = statistics.median(wn.values())
    return [abs(gn[k] - wn[k]) / max(wn[k], med) for k in names]


class Replay:
    """The random draws a system made, handed out again in order: each
    call asks for the next draw of a kind and shape."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.at = 0

    def take(self, kind, shape):
        fn, got = self.draws[self.at]
        if fn != kind or tuple(got.shape) != tuple(shape):
            raise RuntimeError(
                f"draw {self.at}: the system drew {fn}{tuple(got.shape)}, "
                f"the reference asks for {kind}{tuple(shape)}")
        self.at += 1
        return got

    def rand(self, shape):
        return self.take("rand", shape)


def check_dcn_grads(ref, grads) -> tuple:
    """(the largest gap of a DCN's backward, the number of the main
    tower's DCNs whose backward did not run): each DCN of the system's
    first step followed backward by the reference's module of that
    name."""
    worst, missing = 0.0, 0
    with REFERENCE.matmul():
        for name, mod in ref.named_modules():
            if not is_dcn(mod):
                continue
            rec = grads.get(name)
            if not _ran(rec):
                missing += name.startswith("img_backbone.")
                continue
            _, gap = vjp(lambda a, mod=mod: mod(a[0]), rec,
                         dict(mod.named_parameters()))
            worst = max(worst, gap)
    return worst, missing


def check_train(ref, step_fn, sut: dict, ring) -> dict:
    """The gaps of the first step's stages and of the steps followed.
    ``sut``: what the system did (``loss`` [3], ``grad_norm`` [3],
    ``draws`` [3] lists of draws, ``xyz`` [3] its anchors' positions or
    None, ``stages`` its first step's :class:`FrameCapture`, ``grads``
    its first step's :class:`GradCapture`, ``grad`` its first step's
    gradient and ``change`` the steps' change by trained leaf);
    ``step_fn`` the reference's :class:`reference.model.TrainStep`;
    ``ring`` the samples."""
    c = ref.c
    out = {}
    draws0 = sut["draws"][0]
    replay = Replay(draws0)
    draws = None
    if c["version"] == 2:
        # the lifter's draws: the depth uniforms, then the pad draws
        u = replay.take("rand", draws0[0][1].shape)
        pick = replay.take("randint", draws0[1][1].shape)
        noise = replay.take("randn", draws0[2][1].shape) * 0.1
        draws = (pick, noise, u)
    stages = sut["stages"]
    # the first step's forward and backward, stage by stage, before the
    # reference's weights move
    out.update(check_frame(ref, stages, ring[0], draws, stages["head"][1],
                           draws0[replay.at:], sut["grads"]))
    out["dcn_grad_rel"], missing = check_dcn_grads(ref, sut["grads"])
    out["stages_missing"] += missing
    start = {k: p.detach().clone() for k, p in step_fn.trained.items()}
    losses, norms, first = [], [], None
    for s in range(len(sut["loss"])):
        replay = Replay(sut["draws"][s])
        if c["version"] == 2:
            for kind in ("rand", "randint", "randn"):
                replay.take(kind, replay.draws[replay.at][1].shape)
        loss, _, norm, grads = step_fn(ring[s], sut["xyz"][s], replay.rand)
        losses.append(loss.item())
        norms.append(norm.item())
        if first is None:
            first = grads
    gaps = [abs(a - float(b)) / abs(a) for a, b in zip(losses, sut["loss"])]
    out["loss_gap"] = max(gaps)
    out["loss_gap_first"] = gaps[0]
    out["grad_norm_gap"] = max(abs(a - float(b)) / abs(a) for a, b in
                               zip(norms, sut["grad_norm"]))
    names = sorted(first)
    clipped = leaf_gaps(sut["grad"], first, names)
    out["grad_leaf_gap"] = max(clipped)
    out["grad_leaf_median"] = statistics.median(clipped)
    # the gradient before the clipping: each side's clipped gradient times
    # its own global norm over the limit, where it clipped
    max_norm = step_fn.max_norm
    ref_first = {k: g * max(norms[0] / max_norm, 1.0)
                 for k, g in first.items()}
    raw = leaf_gaps(sut["grad"], ref_first, names,
                    max(float(sut["grad_norm"][0]) / max_norm, 1.0))
    out["raw_leaf_gap"] = max(raw)
    out["raw_leaf_median"] = statistics.median(raw)
    gnorm = {k: torch.linalg.vector_norm(first[k].double()).item()
             for k in names}
    med = statistics.median(gnorm.values())
    # leaves the reference's gradient leaves at rounding noise move under
    # Adam by noise alone: their change is not compared
    kept = [k for k in names if gnorm[k] >= 1e-3 * med]
    change = {k: step_fn.trained[k].detach() - start[k] for k in kept}
    changed = leaf_gaps(sut["change"], change, kept)
    out["change_leaf_gap"] = max(changed)
    out["change_leaf_median"] = statistics.median(changed)
    worst = sorted(zip(raw, names), reverse=True)[:5]
    out["raw_worst_leaves"] = [[n, g] for g, n in worst]
    worst = sorted(zip(changed, kept), reverse=True)[:5]
    out["change_worst_leaves"] = [[n, g] for g, n in worst]
    return out
