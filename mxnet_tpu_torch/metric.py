"""Evaluation metrics (PyTorch counterpart of ``mxnet_tpu/metric.py``).

The same ``EvalMetric`` hierarchy, ``sum_metric / num_inst`` accumulators
and ``create`` contract as the JAX package, for the metrics ``fit`` and
``score`` use: ``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``,
``Perplexity``, ``Loss`` and ``CompositeEvalMetric``. Updates run in
numpy on the host, as the JAX package's host path does (``_as_np``): each
batch's outputs are read back from the card once. The JAX package's device-side tally (``fused_stat``)
is not ported.
"""
from __future__ import annotations

import math

import numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "Loss", "check_label_shapes",
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
        self.reset()

    def update(self, label, pred):
        raise NotImplementedError()

    def reset(self):
        many = self.num is not None
        self.sum_metric = [0.0] * self.num if many else 0.0
        self.num_inst = [0] * self.num if many else 0

    def get(self):
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

    def get(self):
        parts = [child.get() for child in self.metrics]
        return ([p[0] for p in parts], [p[1] for p in parts])


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
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class Loss(EvalMetric):
    """Mean of the raw outputs (for MakeLoss heads)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for out in preds:
            self.sum_metric += float(_as_np(out).sum())
            self.num_inst += out.size


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
    "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
    "loss": Loss,
}


def create(metric, **kwargs):
    """A metric from a name, an ``EvalMetric`` or a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(child)
        return composite
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except (KeyError, AttributeError):
        raise ValueError("Metric must be an EvalMetric, a list or one of "
                         "{}".format(sorted(_REGISTRY)))
