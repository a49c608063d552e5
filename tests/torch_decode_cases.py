"""The decode programs at a small size, for the tests of their port
(tests/test_torch_decode_programs.py, tests/test_torch_program.py). It
imports only the packages it is handed.

V 64, d 32, 2 heads, 2 layers, 3 slots, max_len 32, prompt bucket 8; the
paged cache has blocks of 8 rows, 13 of them (block 0 the trash block,
then four for each slot), and speculative decoding proposes 3 tokens."""
import numpy as np

CFG = dict(vocab_size=64, seq_len=32, d_model=32, n_head=2, n_layer=2,
           d_ff=64, dropout=0.0, attn_dropout=0.0)
SLOTS, MAX_LEN, BUCKET, BLOCK, SPEC_K = 3, 32, 8, 8, 3
MAX_BLOCKS = MAX_LEN // BLOCK
NUM_BLOCKS = 1 + SLOTS * MAX_BLOCKS
PROGRAMS = ('decode_step', 'decode_step_paged', 'prefill', 'prefill_paged',
            'drafter', 'verify')
SAMPLE_FEEDS = ('gen_temp', 'gen_topk', 'gen_topp', 'gen_u')


def config(tmod, flash=True):
    return tmod.LMConfig(use_flash_attention=flash, **CFG)


def build(pkg, tmod, which, flash=True):
    """(main, startup, the dict of variables its build function returns)
    of one decode program, its parameters initialised by a seeded startup
    program."""
    cfg = config(tmod, flash)
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 11
    main.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if which == 'decode_step':
            v = tmod.build_lm_decode_step(cfg, SLOTS, MAX_LEN)
        elif which == 'decode_step_paged':
            v = tmod.build_lm_decode_step(cfg, SLOTS, MAX_LEN,
                                          block_size=BLOCK,
                                          num_blocks=NUM_BLOCKS)
        elif which == 'prefill':
            v = tmod.build_lm_prefill(cfg, BUCKET, SLOTS, MAX_LEN)
        elif which == 'prefill_paged':
            v = tmod.build_lm_prefill_paged(cfg, BUCKET, NUM_BLOCKS, BLOCK,
                                            MAX_BLOCKS)
        elif which == 'drafter':
            v = tmod.build_lm_drafter(cfg, SLOTS, MAX_LEN, SPEC_K,
                                      NUM_BLOCKS, BLOCK)
        else:
            v = tmod.build_lm_verify(cfg, SLOTS, SPEC_K + 1, MAX_LEN,
                                     NUM_BLOCKS, BLOCK)
    return main, startup, v


def cache_shape(paged):
    dh = CFG['d_model'] // CFG['n_head']
    rows = (NUM_BLOCKS, BLOCK) if paged else (SLOTS, MAX_LEN)
    return (rows[0], CFG['n_layer'], CFG['n_head'], rows[1], dh)


def tables():
    """The slots' block tables [SLOTS, MAX_BLOCKS]: slot s owns blocks
    1 + 4 s .. 4 + 4 s."""
    return (1 + np.arange(SLOTS * MAX_BLOCKS, dtype='int64')).reshape(
        SLOTS, MAX_BLOCKS)


# each slot's prompt length, and its sampling: slot 1 samples, the others
# are greedy (temperature 0)
LENGTHS = (5, 8, 3)
TEMP = (0.0, 0.8, 0.0)
TOPK = (0, 10, 0)
TOPP = (0.0, 0.9, 0.0)


def prompts(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in LENGTHS:
        p = np.zeros((1, BUCKET), 'int64')
        p[0, :n] = rs.randint(1, CFG['vocab_size'], n)
        out.append(p)
    return out


def sample_feed(rows, u):
    """The sampling quad of ``rows`` (slot indices) with uniform ``u``."""
    rows = list(rows)
    return {'gen_temp': np.asarray([[TEMP[s]] for s in rows], 'float32'),
            'gen_topk': np.asarray([[TOPK[s]] for s in rows], 'int64'),
            'gen_topp': np.asarray([[TOPP[s]] for s in rows], 'float32'),
            'gen_u': np.full((len(rows), 1), u, 'float32')}


def prefill_feed(slot, prompt, paged):
    f = {'gen_prompt': prompt,
         'gen_len': np.asarray([[LENGTHS[slot]]], 'int64')}
    if paged:
        f['gen_pos'] = np.arange(BUCKET, dtype='int64')[None]
        f['gen_btab'] = tables()[slot:slot + 1]
    else:
        f['gen_slot'] = np.asarray([[slot]], 'int64')
    f.update(sample_feed([slot], 0.25 + 0.2 * slot))
    return f


def decode_feed(tokens, pos, step, paged):
    f = {'gen_tokens': np.asarray(tokens, 'int64').reshape(SLOTS, 1),
         'gen_pos': np.asarray(pos, 'int64').reshape(SLOTS, 1)}
    if paged:
        f['gen_btab'] = tables()
    f.update(sample_feed(range(SLOTS), 0.1 + 0.13 * step))
    return f


def drafter_feed(tokens, pos):
    return {'gen_tokens': np.asarray(tokens, 'int64').reshape(SLOTS, 1),
            'gen_pos': np.asarray(pos, 'int64').reshape(SLOTS, 1),
            'gen_btab': tables(),
            'gen_vmask': np.ones((SLOTS, SPEC_K + 1), 'int64')}


def verify_feed(tokens, drafts, pos):
    """Row 0 of each slot its last token, rows 1.. the drafts; positions
    clipped to MAX_LEN - 1, as the engine clips them."""
    toks = np.concatenate([np.asarray(tokens, 'int64').reshape(SLOTS, 1),
                           np.asarray(drafts, 'int64')], axis=1)
    p = np.minimum(np.asarray(pos, 'int64').reshape(SLOTS, 1) +
                   np.arange(SPEC_K + 1), MAX_LEN - 1)
    return {'gen_tokens': toks, 'gen_pos': p, 'gen_btab': tables(),
            'gen_vmask': np.ones((SLOTS, SPEC_K + 1), 'int64')}
