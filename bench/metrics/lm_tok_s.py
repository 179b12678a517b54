"""lm_tok_s: the tokens of every step completed in the window over the
window's seconds."""


def read(rec):
    if not rec.units or not rec.tokens_per_unit:
        return None
    return rec.units * rec.tokens_per_unit / rec.window_s
