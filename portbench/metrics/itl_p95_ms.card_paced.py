"""itl_p95_ms.card_paced: itl_p95_ms in the cells whose pace the card
sets, which repeat within about half a percent and so carry a bound of
their own."""

from portbench.metrics_common import itl_p95_ms as read  # noqa: F401
