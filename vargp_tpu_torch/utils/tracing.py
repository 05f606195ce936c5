"""The port's spans and its launch counters.

Spans mark the layer boundaries of a ``predict`` call and an ELBO step:

  ``predict``      the whole of ``models.vargp.predict``: the host's enqueue
                   time of a call
  ``posterior``    ``build_posterior``: the hyper-sample draw, the Gram
                   K_zz, its factor and inverse, the factored posterior
                   (in ``predict`` only on a call that builds it)
  ``marginal``     ``marginal_diag``: K_zx and the diagonal marginal
  ``features``     under the deep kernel, one application of its feature
                   map phi, nested in ``posterior`` or ``marginal``
  ``likelihood``   ``softmax_predict`` in ``predict``, ``softmax_loss`` in
                   ``loss``
  ``train_block``  one train block of any model (``train.loop.step_block``)
  ``elbo_step``    one step of any model (``train.loop.gradient_step``:
                   VAR-GP's, the global SVGP's, Retrain's and the
                   regression's); under VAR-GP ``posterior``,
                   ``marginal`` and ``likelihood`` nest in it, and so do
  ``backward``     its ``torch.autograd.grad``
  ``update``       its ``opt.update``

A span is recorded only while a ``torch.profiler`` session is active in
the process (``torch.autograd.profiler._is_profiler_enabled``, set by the
profiler's start whatever its activities), and never while
``torch.compile`` or ``torch.export`` traces (``torch.compiler.is_compiling``):
otherwise ``span`` returns one shared object that does nothing, at the
cost of a flag read.  A recorded span also enters a record function
under its name, so it shows in the profiler's own trace as a host row:
``torch._C._profiler._RecordFunctionFast``, the form ``torch.compile``
uses, which costs the host about a tenth of what
``torch.profiler.record_function``'s pair of dispatched operators costs.
Its start and end are ``time.time_ns()``, the clock the profiler's
events are read on, so the device's events can be joined with the spans
that launched them.

Spans live in memory, at most ``CAPACITY`` of them (the oldest drop out),
read with :func:`spans` and dropped with :func:`clear`.  The spans of a
process are opened and closed on one thread.

``LAUNCHES`` counts the hand-written kernels' launches by their C
launcher's symbol (``vargp_sym_gram``, ...), always, one per successful
launch in ``ops.cuda.build.launch``.

``POSTERIOR`` counts, always, each ``models.vargp.predict`` call's chain
posterior: ``build`` when the call built it, ``reuse`` when it reused the
one the last build left (the same unchanged inputs).  The ``posterior``
span opens only around a build, so a trace's ``posterior`` time is the
builds' and ``POSTERIOR`` gives the share of calls that built.

``FEATURES`` counts, always, the rows that go through the deep kernel's
feature map: ``chain`` for the chain's inducing rows (every class's),
``batch`` for rows of x.
"""

import collections
import itertools
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

# the spans that open a call or a step: each opens a new call id, and the
# spans nested in it share that id
UNITS = ("predict", "elbo_step")
CAPACITY = 1 << 16

# launcher symbol -> successful launches, in this process
LAUNCHES = collections.Counter()
# "build" / "reuse" -> predict calls that built / reused the chain posterior
POSTERIOR = collections.Counter()
# "chain" / "batch" -> rows that went through the deep kernel's feature map
FEATURES = collections.Counter()


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    id: int  # this span's, unique in the process
    parent: int  # the id of the span open around it, 0 when none
    call: int  # the id of the call or step it belongs to


_spans = collections.deque(maxlen=CAPACITY)
_open = []  # the open spans, innermost last
_ids = itertools.count(1)
_calls = itertools.count(1)


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recording:
    __slots__ = ("name", "start", "id", "parent", "call", "_annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else 0
        self.call = next(_calls) if outer is None or self.name in UNITS else outer.call
        _open.append(self)
        # the annotation lies inside the span, and so does every op in it
        self.start = time.time_ns()
        self._annotation = torch._C._profiler._RecordFunctionFast(self.name)
        self._annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self._annotation.__exit__(*exc)
        _open.pop()
        _spans.append(Span(self.name, self.start, time.time_ns(), self.id, self.parent,
                           self.call))
        return False


def span(name: str):
    """A context manager around one layer's work: recorded while a
    ``torch.profiler`` session is active, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NO_SPAN
    return _Recording(name)


def spans() -> list:
    """The recorded spans, in the order they closed."""
    return list(_spans)


def clear() -> None:
    _spans.clear()

