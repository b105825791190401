"""The dose-response application (counterpart of
functionalmf_tpu/apps/doseresponse)."""
