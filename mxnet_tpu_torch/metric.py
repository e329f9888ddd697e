"""Evaluation metrics (PyTorch counterpart of ``mxnet_tpu/metric.py``).

The same ``EvalMetric`` hierarchy, ``sum_metric / num_inst`` accumulators
and ``create`` contract as the JAX package, for the metrics ``fit`` and
``score`` use: ``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``,
``Perplexity``, ``Loss``, ``CompositeEvalMetric`` and ``CustomMetric``.
``update`` runs in numpy on the host, as the JAX package's host path does
(``_as_np``): each batch's outputs are read back from the card once.
``F1`` (binary, averaged per batch), ``MAE``, ``MSE`` and ``RMSE`` are
MXNet 0.9.5's; the regression scores update on the host only. ``Torch``
and ``Caffe`` are ``Loss`` under the plugins' names.

The device-side tally: every metric but ``CustomMetric`` and the
regression scores also has a
``fused_stat`` — a function ``stat(torch, labels, preds)`` that returns
this batch's ``(sum, count)`` (a tensor on the outputs' device or a Python
number; a composite returns one pair per leaf metric) and equals what
``update`` would add. ``Module.fit`` and ``score`` on the fused route
(``MeshExecutorGroup.enable_device_metric`` / ``score_device``) add those
rows into a device tally inside the step, and the metric reads it back
once, in ``get``: no per-batch readback.
"""
from __future__ import annotations

import math

import numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "Loss", "F1", "MAE", "MSE", "RMSE",
           "Torch", "Caffe", "CustomMetric", "np", "check_label_shapes",
           "create"]


def _as_np(x):
    """NDArray / tensor / array-like -> host numpy array."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return numpy.asarray(x)


def check_label_shapes(labels, preds, shape=0):
    """Raise when the label / prediction structure disagrees."""
    got = (labels.shape, preds.shape) if shape else (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(*got))


class EvalMetric(object):
    """Base class: a running ``sum_metric / num_inst`` ratio (list-valued
    when ``num`` outputs are scored separately)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self._dev_read = None   # () -> numpy (n_slots, 2) device tally
        self._dev_zero = None   # () -> None, resets the device tally
        self.reset()

    def update(self, label, pred):
        raise NotImplementedError()

    def reset(self):
        many = self.num is not None
        self.sum_metric = [0.0] * self.num if many else 0.0
        self.num_inst = [0] * self.num if many else 0
        if self._dev_zero is not None:
            self._dev_zero()

    def get(self):
        self._drain_device()
        if self.num is None:
            if not self.num_inst:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        values = [s / n if n else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (["%s_%d" % (self.name, i) for i in range(self.num)], values)

    def get_name_value(self):
        names, values = self.get()
        names = names if isinstance(names, list) else [names]
        values = values if isinstance(values, list) else [values]
        return list(zip(names, values))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    # -- the device tally ----------------------------------------------
    def fused_stat(self):
        """The device-side statistic, or ``None`` (host path only): a
        function ``stat(torch, labels, preds) -> (sum, count)`` that runs
        on the outputs' device without reading anything back and equals
        what ``update`` adds to ``sum_metric`` / ``num_inst``."""
        return None

    def _leaf_stats(self):
        """Flat list of per-row stat functions (None: host only)."""
        return [self.fused_stat()]

    def _bind_device_tally(self, reader, zeroer):
        """Attach a device tally (the fused Module route calls this)."""
        self._dev_read = reader
        self._dev_zero = zeroer

    def _unbind_device_tally(self):
        self._dev_read = self._dev_zero = None

    def _drain_device(self):
        """Fold the device tally into the host sums (one readback)."""
        if self._dev_read is None:
            return
        tally = numpy.asarray(self._dev_read())
        self._dev_zero()
        self._fold_tally(tally)

    def _fold_tally(self, tally):
        self.sum_metric += float(tally[0, 0])
        self.num_inst += int(round(float(tally[0, 1])))

    def _n_slots(self):
        """Rows this metric occupies in a shared device tally."""
        return 1


class CompositeEvalMetric(EvalMetric):
    """Several metrics managed as one."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = [] if metrics is None else metrics

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", []):
            child.reset()
        if getattr(self, "_dev_zero", None) is not None:
            self._dev_zero()

    def get(self):
        self._drain_device()
        parts = [child.get() for child in self.metrics]
        return ([p[0] for p in parts], [p[1] for p in parts])

    def _leaf_stats(self):
        flat = []
        for child in self.metrics:
            flat.extend(child._leaf_stats())
        return flat

    def fused_stat(self):
        # the leaves' rows, flattened so nested composites line up with
        # the recursive _fold_tally / _n_slots layout
        stats = self._leaf_stats()
        if not stats or any(s is None for s in stats):
            return None

        def stat(xp, labels, preds):
            return [s(xp, labels, preds) for s in stats]

        stat.n_slots = len(stats)
        return stat

    def _fold_tally(self, tally):
        row = 0
        for child in self.metrics:
            n = child._n_slots()
            child._fold_tally(tally[row:row + n])
            row += n

    def _n_slots(self):
        return sum(child._n_slots() for child in self.metrics)


def _decide_labels(scores, label_shape):
    """When prediction and label shapes differ, class scores live on
    axis 1 (the JAX package's rule, numpy's ``argmax`` tie-break)."""
    if scores.ndim > 1 and scores.shape != tuple(label_shape):
        return scores.argmax(axis=1)
    return scores


class Accuracy(EvalMetric):
    """Classification accuracy; ``pred_index`` scores one output of a
    multi-output symbol."""

    def __init__(self, pred_index=None):
        super().__init__("accuracy")
        self.pred_index = pred_index

    def _select(self, preds):
        if self.pred_index is None:
            return preds
        return preds[self.pred_index:self.pred_index + 1]

    def update(self, labels, preds):
        preds = self._select(preds)
        check_label_shapes(labels, preds)
        for lab, out in zip(labels, preds):
            decided = _decide_labels(_as_np(out), tuple(lab.shape))
            got = decided.astype("int64").ravel()
            want = _as_np(lab).astype("int64").ravel()
            check_label_shapes(want, got)
            self.sum_metric += int((got == want).sum())
            self.num_inst += want.size

    def fused_stat(self):
        select = self._select

        def stat(xp, labels, preds):
            hits, seen = 0.0, 0
            for lab, out in zip(labels, select(preds)):
                decided = out.argmax(dim=1) \
                    if out.dim() > 1 and tuple(out.shape) != \
                    tuple(lab.shape) else out
                eq = decided.to(xp.int32).reshape(-1) == \
                    lab.to(xp.int32).reshape(-1)
                hits = hits + eq.sum().to(xp.float32)
                seen += eq.numel()
            return hits, seen

        return stat


class TopKAccuracy(EvalMetric):
    """Fraction of samples whose label lands in the top-k scores
    (``argpartition``; ties at the k-boundary are unspecified, as in the
    JAX package)."""

    def __init__(self, top_k=1):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for lab, out in zip(labels, preds):
            scores = _as_np(out).astype("float32")
            want = _as_np(lab).astype("int64").ravel()
            if scores.ndim == 1:
                hits = int((scores.astype("int64") == want).sum())
            else:
                if scores.ndim != 2:
                    raise ValueError("predictions must be at most "
                                     "2-dimensional")
                k = min(self.top_k, scores.shape[1])
                kset = numpy.argpartition(scores, -k, axis=1)[:, -k:]
                hits = int((kset == want[:, None]).any(axis=1).sum())
            self.sum_metric += hits
            self.num_inst += want.size

    def fused_stat(self):
        top_k = self.top_k

        def stat(xp, labels, preds):
            hits, seen = 0.0, 0
            for lab, out in zip(labels, preds):
                want = lab.to(xp.int32).reshape(-1)
                if out.dim() == 1:
                    eq = out.to(xp.int32) == want
                    hits = hits + eq.sum().to(xp.float32)
                else:
                    k = min(top_k, out.shape[1])
                    kset = xp.topk(out.to(xp.float32), k, dim=1).indices
                    inset = (kset == want[:, None]).any(dim=1)
                    hits = hits + inset.sum().to(xp.float32)
                seen += want.numel()
            return hits, seen

        return stat


class CrossEntropy(EvalMetric):
    """Mean -log p(label) over samples; ``pred`` rows are probabilities."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for lab, out in zip(labels, preds):
            probs = _as_np(out)
            ids = _as_np(lab).ravel().astype("int64")
            if ids.size != probs.shape[0]:
                raise ValueError("one label per prediction row is needed")
            chosen = probs[numpy.arange(ids.size), ids]
            self.sum_metric += float(-numpy.log(chosen + self.eps).sum())
            self.num_inst += ids.size

    def fused_stat(self):
        eps = self.eps

        def stat(xp, labels, preds):
            total, seen = 0.0, 0
            for lab, out in zip(labels, preds):
                ids = lab.to(xp.int64).reshape(-1)
                chosen = xp.gather(out.to(xp.float32), 1,
                                   ids[:, None])[:, 0]
                total = total - xp.log(chosen + eps).sum()
                seen += ids.numel()
            return total, seen

        return stat


class Perplexity(EvalMetric):
    """exp(mean negative log-likelihood) over every scored position;
    ``ignore_label`` masks padding. ``pred`` rows are probabilities over
    the last axis, one row per label."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        nll, count = 0.0, 0
        for lab, out in zip(labels, preds):
            probs = _as_np(out)
            probs = probs.reshape(-1, probs.shape[-1])
            ids = _as_np(lab).astype("int64").ravel()
            chosen = probs[numpy.arange(ids.size), ids]
            keep = numpy.ones(ids.size, bool) if self.ignore_label is None \
                else ids != self.ignore_label
            nll -= float(numpy.log(numpy.maximum(chosen, 1e-10))[keep].sum())
            count += int(keep.sum())
        self.sum_metric += nll
        self.num_inst += count

    def get(self):
        self._drain_device()
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def fused_stat(self):
        ignore = self.ignore_label

        def stat(xp, labels, preds):
            nll, count = 0.0, 0
            for lab, out in zip(labels, preds):
                probs = out.reshape(-1, out.shape[-1]).to(xp.float32)
                ids = lab.to(xp.int64).reshape(-1)
                chosen = xp.gather(probs, 1, ids[:, None])[:, 0]
                logp = xp.log(xp.clamp_min(chosen, 1e-10))
                if ignore is None:
                    nll = nll - logp.sum()
                    count += ids.numel()
                else:
                    keep = (ids != int(ignore)).to(xp.float32)
                    nll = nll - (logp * keep).sum()
                    count = count + keep.sum()
            return nll, count

        return stat


class Loss(EvalMetric):
    """Mean of the raw outputs (for MakeLoss heads)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for out in preds:
            self.sum_metric += float(_as_np(out).sum())
            self.num_inst += out.size

    def fused_stat(self):
        def stat(xp, labels, preds):
            total, seen = 0.0, 0
            for out in preds:
                total = total + out.to(xp.float32).sum()
                seen += out.numel()
            return total, seen

        return stat


class F1(EvalMetric):
    """Binary-classification F1, averaged per batch."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for lab, out in zip(labels, preds):
            scores = _as_np(out)
            want = _as_np(lab).astype("int64").ravel()
            check_label_shapes(want, scores)
            if numpy.unique(want).size > 2:
                raise ValueError(
                    "F1 currently only supports binary classification.")
            got = scores.argmax(axis=1)
            tp = int(((got == 1) & (want == 1)).sum())
            fp = int(((got == 1) & (want == 0)).sum())
            fn = int(((got == 0) & (want == 1)).sum())
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            both = precision + recall
            self.sum_metric += 2.0 * precision * recall / both if both else 0.0
            self.num_inst += 1

    def fused_stat(self):
        def stat(xp, labels, preds):
            total, seen = 0.0, 0
            for lab, out in zip(labels, preds):
                got = out.argmax(dim=1)
                want = lab.to(xp.int64).reshape(-1)
                tp = ((got == 1) & (want == 1)).sum().double()
                fp = ((got == 1) & (want == 0)).sum().double()
                fn = ((got == 0) & (want == 1)).sum().double()
                precision = xp.where(tp + fp > 0, tp / (tp + fp).clamp(min=1),
                                     xp.zeros_like(tp))
                recall = xp.where(tp + fn > 0, tp / (tp + fn).clamp(min=1),
                                  xp.zeros_like(tp))
                both = precision + recall
                f1 = xp.where(both > 0, 2.0 * precision * recall /
                              both.clamp(min=1e-300), xp.zeros_like(both))
                total = total + f1.float()
                seen += 1
            return total, seen

        return stat


class _BatchScore(EvalMetric):
    """Regression scores: one score per (label, pred) pair, averaged."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for lab, out in zip(labels, preds):
            want, got = _as_np(lab), _as_np(out)
            want = want.reshape(want.shape[0], -1)
            got = got.reshape(got.shape[0], -1)
            self.sum_metric += float(self._score(want, got))
            self.num_inst += 1


class MAE(_BatchScore):
    def __init__(self):
        super().__init__("mae")

    @staticmethod
    def _score(want, got):
        return numpy.abs(want - got).mean()


class MSE(_BatchScore):
    def __init__(self):
        super().__init__("mse")

    @staticmethod
    def _score(want, got):
        return ((want - got) ** 2).mean()


class RMSE(_BatchScore):
    def __init__(self):
        super().__init__("rmse")

    @staticmethod
    def _score(want, got):
        return numpy.sqrt(((want - got) ** 2).mean())


class Torch(Loss):
    """The loss of a Torch criterion head (``mx.torch``): the mean of the
    raw outputs."""

    def __init__(self, name="torch"):
        super(Loss, self).__init__(name)


class Caffe(Torch):
    """The loss of a Caffe net (``mx.plugin.caffe``)."""

    def __init__(self):
        super().__init__("caffe")


class CustomMetric(EvalMetric):
    """Host-only metric from a user ``feval(label, pred)`` callable; it
    has no device statistic, so ``fit`` keeps the per-batch host path."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for out, lab in zip(preds, labels):
            got = self._feval(_as_np(lab), _as_np(out))
            if isinstance(got, tuple):
                part_sum, part_n = got
                self.sum_metric += part_sum
                self.num_inst += part_n
            else:
                self.sum_metric += got
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy eval function as a metric (the reference's
    ``metric.np``)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
    "loss": Loss,
}


def create(metric, **kwargs):
    """A metric from a name, an ``EvalMetric``, a callable ``feval``
    (a ``CustomMetric``) or a list of any of these."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(child)
        return composite
    if callable(metric):
        return CustomMetric(metric)
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except (KeyError, AttributeError):
        raise ValueError("Metric must be an EvalMetric, a list or one of "
                         "{}".format(sorted(_REGISTRY)))
