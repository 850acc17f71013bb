"""GAME (fixed effects + per-entity random effects) training on one
device: data and size bins (``data``), the batched entity solves
(``batched_solve``), models and their files (``model``, ``model_io``), the
score tables (``residuals``), coordinates, coordinate descent and the
sweep estimator, and the streamed (out-of-core) descent over host score
tiles (``tiles``, ``stream_descent``).  Counterpart of ``photon_tpu/game``."""
