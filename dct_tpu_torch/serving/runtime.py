"""Host-side serving helpers (counterpart of ``dct_tpu/serving/runtime.py``).

The request contract is the reference's: ``{"data": [...]}`` parsed into a
float32 array (:func:`parse_envelope_array` fast path, ``json.loads``
otherwise), validated per family (:func:`validate_payload`: a failure is
the request's fault, HTTP 400), scored, and answered as probabilities.
Packages store weights as f32 arrays, ``k::bf16`` uint16 bit patterns, or
int8 ``k::q8`` + ``k::scale`` pairs, which :func:`assemble_weights`
turns into :class:`QuantTensor` leaves (int8 with per-output-channel f32
scales).

Every name here is the one of :mod:`dct_tpu_torch.serving.numpy_runtime`,
the port's verbatim copy of the reference's runtime (the text a package's
``score.py`` embeds), so the HTTP tier, the numpy engine and a deployed
``score.py`` share one implementation.
"""

from __future__ import annotations

from dct_tpu_torch.serving.numpy_runtime import (  # noqa: F401 (re-exports)
    _SEQUENCE_FAMILIES,
    QuantTensor,
    assemble_weights,
    bf16_pack,
    bf16_unpack,
    forward_numpy,
    parse_envelope_array,
    rows_mm,
    score_payload,
    softmax_numpy,
    validate_payload,
)
