"""Statistical tail functions vs FROZEN high-precision literals.

The per-variant GLM oracles previously computed their
expected p-values with the *production* tail functions, so a bug in the
shared tail code would pass the oracle comparison. These tables were
generated offline with mpmath at 50 decimal digits (independent
arbitrary-precision algorithm — Gauss continued fractions / hypergeometric
series, not the production Lentz continued fraction) and frozen as
literals; the tests compare the production implementations against them
point-by-point.

Generator (run with mpmath >= 1.3):
    mp.mp.dps = 50
    t_sf2(t, df)   = mp.betainc(df/2, 1/2, 0, df/(df+t*t), regularized=True)
    betainc(a,b,x) = mp.betainc(a, b, 0, x, regularized=True)
    normal_sf2(z)  = mp.erfc(z / sqrt(2))
"""

import numpy as np

from pgen_tpu.ops.glm import betainc_reg, t_sf2
from pgen_tpu.ops.logistic import normal_sf2

# (t, df, P(|T_df| >= t)) — two-sided t tail
T_SF2_TABLE = [
    (0.5, 1, 0.70483276469913345),
    (2.0, 1, 0.29516723530086655),
    (12.706, 1, 0.050000802358133188),
    (5.0, 2, 0.037749551350623726),
    (1.0, 3, 0.39100221895577064),
    (2.571, 5, 0.049974634683851392),
    (4.0, 7, 0.0051899133492968116),
    (2.228, 10, 0.050011771817111365),
    (0.1, 10, 0.92232071856440832),
    (37.0, 10, 4.9498909653971131e-12),
    (3.0, 30, 0.0053899640656519466),
    (8.5, 30, 1.7440884683465775e-9),
    (2.0, 100, 0.04821217873113368),
    (5.2, 100, 1.0598662896663302e-6),
    (1.5, 1000, 0.13393003882208617),
    (300.0, 50, 4.5978719830635606e-83),
    (0.01, 5, 0.9924080180425819),
    (6.0, 2504, 2.258872552327069e-9),
    (25.0, 2497, 2.68749862586023e-123),
    (1.96, 1e9, 0.049995790573729595),
]

# (a, b, x, I_x(a, b)) — regularized incomplete beta
BETAINC_TABLE = [
    (0.5, 0.5, 0.25, 0.33333333333333333),
    (0.5, 0.5, 0.999, 0.9798649583666225),
    (1.0, 1.0, 0.3, 0.29999999999999999),
    (2.0, 3.0, 0.5, 0.6875),
    (5.0, 0.5, 0.1, 2.5705896992293735e-6),
    (5.0, 0.5, 0.99, 0.7571581091015624),
    (50.0, 0.5, 0.9, 0.001204149832559813),
    (50.0, 0.5, 0.999, 0.75236901996537668),
    (0.5, 5.0, 0.01, 0.2428418908984375),
    (10.0, 10.0, 0.5, 0.5),
    (10.0, 10.0, 0.05, 5.9393390596643823e-9),
    (100.0, 0.5, 0.995, 0.31730898797001044),
    (1252.0, 0.5, 0.99, 5.2737417430605638e-7),
    (1252.0, 0.5, 0.9999, 0.61681992896534581),
    (0.1, 0.2, 0.5, 0.67057079610289901),
    (3.0, 7.0, 0.123, 0.08838889463385149),
    (25.0, 2.5, 0.8, 0.042619894557940399),
    (500.0, 0.5, 0.999999, 0.97477917695586112),
    (2.5, 2.5, 0.5, 0.5),
    (1e4, 0.5, 0.9999, 0.1572940177633515),
]

# (z, P(|Z| >= z)) — two-sided normal tail, down to the f64 floor
NORMAL_SF2_TABLE = [
    (0.0, 1.0),
    (0.5, 0.61707507745197379),
    (1.0, 0.3173105078629141),
    (1.959964, 0.049999998192884804),
    (2.575829, 0.01000000877848163),
    (3.0, 0.0026997960632601891),
    (5.0, 5.7330314375838782e-7),
    (8.0, 1.2441921148543568e-15),
    (10.0, 1.5239706048321052e-23),
    (13.0, 1.2234328799099759e-38),
    (20.0, 5.5072482372124674e-89),
    (37.5, 9.2107060191639097e-308),
]


def test_t_sf2_vs_frozen_table():
    for t, df, exp in T_SF2_TABLE:
        got = float(t_sf2(t, df))
        # df >= 1e8 uses the normal limit whose relative error is
        # O(t^4/df) (~4e-9 at t=1.96, df=1e9) — still 100x tighter than
        # the continued fraction there
        rtol = 1e-8 if df >= 1e8 else 1e-11
        np.testing.assert_allclose(got, exp, rtol=rtol, err_msg=f"t={t} df={df}")


def test_betainc_reg_vs_frozen_table():
    for a, b, x, exp in BETAINC_TABLE:
        got = float(betainc_reg(a, b, x))
        np.testing.assert_allclose(
            got, exp, rtol=1e-11, err_msg=f"a={a} b={b} x={x}"
        )


def test_normal_sf2_vs_frozen_table():
    for z, exp in NORMAL_SF2_TABLE:
        got = float(normal_sf2(np.asarray([z]))[0])
        np.testing.assert_allclose(got, exp, rtol=1e-12, err_msg=f"z={z}")
        # symmetry
        got_neg = float(normal_sf2(np.asarray([-z]))[0])
        assert got_neg == got


def test_t_sf2_monotone_in_t():
    # sanity on the continued-fraction switchover: strictly decreasing in |t|
    for df in (1, 2, 7, 100, 2504):
        ts = np.linspace(0.0, 40.0, 81)
        ps = np.array([t_sf2(t, df) for t in ts])
        assert np.all(np.diff(ps) < 0)
