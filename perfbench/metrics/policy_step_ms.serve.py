"""The serving worker's policy-step p50 (HealthSnapshot.step_p50_ms) at the window's end."""


def read(ctx):
    return ctx.get("health", {}).get("step_p50_ms")
