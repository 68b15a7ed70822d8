"""Real rows over computed rows of the recent policy steps (HealthSnapshot.batch_occupancy)."""


def read(ctx):
    return ctx.get("health", {}).get("batch_occupancy")
