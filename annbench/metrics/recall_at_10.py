"""recall_at_10: mean recall@10 of every answer of the window against the
plain reference's exact top-10 (`check.judge`)."""


def read(ctx):
    return ctx.recall
