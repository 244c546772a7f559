"""The learned cost model: measure, then learn, then search.

The port's counterpart of ``flexflow_tpu/costmodel``. A traced ``fit``
of a model compiled with ``--profiling`` writes ``*.simtrace.json``
rows that join each op's identity (class, shape, sharding choice) and
priced terms with its forward and backward times measured on the card
(``obs/simtrace.py``, ``search/profile.py``). This package turns those
rows into a small per-op-class regression and hands its coefficient
table to the native search, which prices the classes it covers with it
and the rest analytically:

- ``corpus``: trace dirs -> a deduplicated, schema-versioned corpus
  (``COSTMODEL_CORPUS_GPU.json``), and the featurization the native
  evaluator mirrors;
- ``model``: a numpy ridge regression in log space per op class with a
  per-class feature hull, saved as ``COSTMODEL_GPU.json`` with coverage
  counts and held-out error; ``load_native_table`` finds it
  (``FFS_COSTMODEL_FILE`` or the repo root's file), gates it on the
  platform of the model's device, and exports the table
  ``search/unity.py`` ``machine_to_json`` sends the core.
  ``FFS_NO_LEARNED_COSTS=1`` turns it off: the search then prices as it
  did without a model, bit for bit.

``python -m flexflow_tpu_torch.scripts.costmodel train`` builds both
files; ``report`` puts the learned and the analytic prices beside the
measured ones, per class and per traced run.
"""

from flexflow_tpu_torch.costmodel.corpus import (CORPUS_SCHEMA_VERSION,
                                                 FEATURE_NAMES,
                                                 CorpusSchemaError,
                                                 build_corpus, featurize,
                                                 load_corpus, load_trace_dir,
                                                 save_corpus)
from flexflow_tpu_torch.costmodel.model import (MIN_CLASS_ROWS,
                                                MODEL_SCHEMA_VERSION,
                                                CostModel,
                                                default_model_path,
                                                load_model,
                                                load_native_table,
                                                train_model)

__all__ = [
    "CORPUS_SCHEMA_VERSION", "FEATURE_NAMES", "CorpusSchemaError",
    "build_corpus", "featurize", "load_corpus", "load_trace_dir",
    "save_corpus", "MIN_CLASS_ROWS", "MODEL_SCHEMA_VERSION", "CostModel",
    "default_model_path", "load_model", "load_native_table", "train_model",
]
