"""model.step_mfu_pct.card_paced: model.step_mfu_pct in the cells whose
pace the card sets; it bounds the gain any kernel roofline there can
claim."""

from portbench.metrics_common import step_mfu_pct as read  # noqa: F401
