// The arithmetic of the inverse-transform kernel (csrc/itx.cu): the 1-D
// transforms, written from the port's recon/itx.py (_1D_FNS, wht4), and
// the phases of one group of jobs (setup, load, row pass, column pass
// with the store).
//
// Every function works in place on a strided line of a tile in shared
// memory and is templated on the element type: int at 8/10-bit (the JAX
// device tier's int32 lanes), long long at 12-bit, where the canonical
// rotations (a*ca + b*cb + 2048) >> 12 overflow int32
// (dav1d_tpu/ops/itx.py:28-38) and int64 is exact.  `>>` is an
// arithmetic shift on signed integers, as in the reference.
//
// The header compiles as CUDA device code (included by itx.cu) and as
// plain C++ (a host build runs the same phases thread by thread), so
// nothing here uses a CUDA builtin.
#pragma once

#ifdef __CUDACC__
#define ITX_FN __device__ inline
#define ITX_NOINLINE __device__ __noinline__
#define ITX_CONST __constant__
#define ITX_TRAP() __trap()
#else
#include <stdlib.h>
#define ITX_FN inline
#define ITX_NOINLINE inline
#define ITX_CONST static const
#define ITX_TRAP() abort()
#endif

namespace itx {

enum { DCT = 0, ADST = 1, FLIPADST = 2, IDENTITY = 3 };
constexpr int WHT_WHT = 16;
constexpr int N_TX = 19;

// Columns of a job row (int32, ops/itx.py job_table).
constexpr int JOB_COLS = 4;
constexpr int J_CF = 0, J_TX = 1, J_TXTP = 2, J_OUT = 3;

// Per tx size (tables.txfm_info order): log2(w / 4), log2(h / 4) and the
// intermediate shift (recon/itx.py TX_SHIFT).
ITX_CONST signed char TX_LW[N_TX] = {0, 1, 2, 3, 4, 0, 1, 1, 2, 2,
                                     3, 3, 4, 0, 2, 1, 3, 2, 4};
ITX_CONST signed char TX_LH[N_TX] = {0, 1, 2, 3, 4, 1, 0, 2, 1, 3,
                                     2, 4, 3, 2, 0, 3, 1, 4, 2};
ITX_CONST signed char TX_SHIFT[N_TX] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                        1, 1, 1, 1, 1, 2, 2, 2, 2};
// Per tx type (TxfmType order, WHT_WHT excluded): the row (horizontal)
// and column (vertical) 1-D types (recon/itx.py TX1D_TYPES; the enum
// names the vertical type first).
ITX_CONST signed char TX_ROW_T[16] = {0, 0, 1, 1, 0, 2, 2, 2,
                                      1, 3, 3, 0, 3, 1, 3, 2};
ITX_CONST signed char TX_COL_T[16] = {0, 1, 0, 1, 2, 0, 2, 1,
                                      2, 3, 0, 3, 1, 3, 2, 3};

template <typename T>
struct Clip {
    T lo, hi;
    ITX_FN T operator()(T v) const { return v < lo ? lo : (v > hi ? hi : v); }
};

template <typename T>
ITX_FN T rr(T a, int ca, T b, int cb) {
    return (a * ca + b * cb + 2048) >> 12;
}

template <typename T>
ITX_FN T r181(T v) {
    return (v * 181 + 128) >> 8;
}

// ---- DCT ---------------------------------------------------------------

template <typename T>
ITX_FN void dct4(T* c, int s, Clip<T> cl) {
    const T in0 = c[0], in1 = c[s], in2 = c[2 * s], in3 = c[3 * s];
    const T t0 = r181<T>(in0 + in2);
    const T t1 = r181<T>(in0 - in2);
    const T t2 = rr<T>(in1, 1567, in3, -3784);
    const T t3 = rr<T>(in1, 3784, in3, 1567);
    c[0] = cl(t0 + t3);
    c[s] = cl(t1 + t2);
    c[2 * s] = cl(t1 - t2);
    c[3 * s] = cl(t0 - t3);
}

template <typename T>
ITX_FN void dct8(T* c, int s, Clip<T> cl) {
    dct4<T>(c, 2 * s, cl);
    const T in1 = c[s], in3 = c[3 * s], in5 = c[5 * s], in7 = c[7 * s];
    T t4a = rr<T>(in1, 799, in7, -4017);
    T t5a = rr<T>(in5, 3406, in3, -2276);
    T t6a = rr<T>(in5, 2276, in3, 3406);
    const T t7a = rr<T>(in1, 4017, in7, 799);
    const T t4 = cl(t4a + t5a);
    t5a = cl(t4a - t5a);
    const T t7 = cl(t7a + t6a);
    t6a = cl(t7a - t6a);
    const T t5 = r181<T>(t6a - t5a);
    const T t6 = r181<T>(t6a + t5a);
    const T t0 = c[0], t1 = c[2 * s], t2 = c[4 * s], t3 = c[6 * s];
    c[0 * s] = cl(t0 + t7);
    c[1 * s] = cl(t1 + t6);
    c[2 * s] = cl(t2 + t5);
    c[3 * s] = cl(t3 + t4);
    c[4 * s] = cl(t3 - t4);
    c[5 * s] = cl(t2 - t5);
    c[6 * s] = cl(t1 - t6);
    c[7 * s] = cl(t0 - t7);
}

template <typename T>
ITX_FN void dct16(T* c, int s, Clip<T> cl) {
    dct8<T>(c, 2 * s, cl);
    const T in1 = c[s], in3 = c[3 * s], in5 = c[5 * s], in7 = c[7 * s];
    const T in9 = c[9 * s], in11 = c[11 * s], in13 = c[13 * s],
            in15 = c[15 * s];

    T t8a = rr<T>(in1, 401, in15, -4076);
    T t9a = rr<T>(in9, 3166, in7, -2598);
    T t10a = rr<T>(in5, 1931, in11, -3612);
    T t11a = rr<T>(in13, 3920, in3, -1189);
    T t12a = rr<T>(in13, 1189, in3, 3920);
    T t13a = rr<T>(in5, 3612, in11, 1931);
    T t14a = rr<T>(in9, 2598, in7, 3166);
    T t15a = rr<T>(in1, 4076, in15, 401);

    T t8 = cl(t8a + t9a);
    T t9 = cl(t8a - t9a);
    T t10 = cl(t11a - t10a);
    T t11 = cl(t11a + t10a);
    T t12 = cl(t12a + t13a);
    T t13 = cl(t12a - t13a);
    T t14 = cl(t15a - t14a);
    T t15 = cl(t15a + t14a);

    t9a = rr<T>(t14, 1567, t9, -3784);
    t14a = rr<T>(t14, 3784, t9, 1567);
    t10a = rr<T>(t13, -3784, t10, -1567);
    t13a = rr<T>(t13, 1567, t10, -3784);

    t8a = cl(t8 + t11);
    t9 = cl(t9a + t10a);
    t10 = cl(t9a - t10a);
    t11a = cl(t8 - t11);
    t12a = cl(t15 - t12);
    t13 = cl(t14a - t13a);
    t14 = cl(t14a + t13a);
    t15a = cl(t15 + t12);

    t10a = r181<T>(t13 - t10);
    t13a = r181<T>(t13 + t10);
    t11 = r181<T>(t12a - t11a);
    t12 = r181<T>(t12a + t11a);

    T e[8];
    for (int k = 0; k < 8; k++) e[k] = c[2 * k * s];
    const T odd[8] = {t15a, t14, t13a, t12, t11, t10a, t9, t8a};
    for (int k = 0; k < 8; k++) {
        c[k * s] = cl(e[k] + odd[k]);
        c[(15 - k) * s] = cl(e[k] - odd[k]);
    }
}

template <typename T>
ITX_FN void dct32(T* c, int s, Clip<T> cl) {
    dct16<T>(c, 2 * s, cl);
    const T in1 = c[1 * s], in3 = c[3 * s], in5 = c[5 * s], in7 = c[7 * s];
    const T in9 = c[9 * s], in11 = c[11 * s], in13 = c[13 * s],
            in15 = c[15 * s];
    const T in17 = c[17 * s], in19 = c[19 * s], in21 = c[21 * s],
            in23 = c[23 * s];
    const T in25 = c[25 * s], in27 = c[27 * s], in29 = c[29 * s],
            in31 = c[31 * s];

    T t16a = rr<T>(in1, 201, in31, -4091);
    T t17a = rr<T>(in17, 3035, in15, -2751);
    T t18a = rr<T>(in9, 1751, in23, -3703);
    T t19a = rr<T>(in25, 3857, in7, -1380);
    T t20a = rr<T>(in5, 995, in27, -3973);
    T t21a = rr<T>(in21, 3513, in11, -2106);
    T t22a = rr<T>(in13, 2440, in19, -3290);
    T t23a = rr<T>(in29, 4052, in3, -601);
    T t24a = rr<T>(in29, 601, in3, 4052);
    T t25a = rr<T>(in13, 3290, in19, 2440);
    T t26a = rr<T>(in21, 2106, in11, 3513);
    T t27a = rr<T>(in5, 3973, in27, 995);
    T t28a = rr<T>(in25, 1380, in7, 3857);
    T t29a = rr<T>(in9, 3703, in23, 1751);
    T t30a = rr<T>(in17, 2751, in15, 3035);
    T t31a = rr<T>(in1, 4091, in31, 201);

    T t16 = cl(t16a + t17a);
    T t17 = cl(t16a - t17a);
    T t18 = cl(t19a - t18a);
    T t19 = cl(t19a + t18a);
    T t20 = cl(t20a + t21a);
    T t21 = cl(t20a - t21a);
    T t22 = cl(t23a - t22a);
    T t23 = cl(t23a + t22a);
    T t24 = cl(t24a + t25a);
    T t25 = cl(t24a - t25a);
    T t26 = cl(t27a - t26a);
    T t27 = cl(t27a + t26a);
    T t28 = cl(t28a + t29a);
    T t29 = cl(t28a - t29a);
    T t30 = cl(t31a - t30a);
    T t31 = cl(t31a + t30a);

    t17a = rr<T>(t30, 799, t17, -4017);
    t30a = rr<T>(t30, 4017, t17, 799);
    t18a = rr<T>(t29, -4017, t18, -799);
    t29a = rr<T>(t29, 799, t18, -4017);
    t21a = rr<T>(t26, 3406, t21, -2276);
    t26a = rr<T>(t26, 2276, t21, 3406);
    t22a = rr<T>(t25, -2276, t22, -3406);
    t25a = rr<T>(t25, 3406, t22, -2276);

    t16a = cl(t16 + t19);
    const T t17_ = cl(t17a + t18a);
    t18 = cl(t17a - t18a);
    t19a = cl(t16 - t19);
    t20a = cl(t23 - t20);
    t21 = cl(t22a - t21a);
    t22 = cl(t22a + t21a);
    t23a = cl(t23 + t20);
    t24a = cl(t24 + t27);
    t25 = cl(t25a + t26a);
    t26 = cl(t25a - t26a);
    t27a = cl(t24 - t27);
    t28a = cl(t31 - t28);
    const T t29_ = cl(t30a - t29a);
    t30 = cl(t30a + t29a);
    t31a = cl(t31 + t28);
    t17 = t17_;
    t29 = t29_;

    t18a = rr<T>(t29, 1567, t18, -3784);
    t29a = rr<T>(t29, 3784, t18, 1567);
    const T t19_ = rr<T>(t28a, 1567, t19a, -3784);
    t28 = rr<T>(t28a, 3784, t19a, 1567);
    const T t20_ = rr<T>(t27a, -3784, t20a, -1567);
    const T t27_ = rr<T>(t27a, 1567, t20a, -3784);
    t21a = rr<T>(t26, -3784, t21, -1567);
    t26a = rr<T>(t26, 1567, t21, -3784);
    t19 = t19_;
    t20 = t20_;
    t27 = t27_;

    t16 = cl(t16a + t23a);
    t17a = cl(t17 + t22);
    const T t18_ = cl(t18a + t21a);
    t19a = cl(t19 + t20);
    t20a = cl(t19 - t20);
    const T t21_ = cl(t18a - t21a);
    t22a = cl(t17 - t22);
    t23 = cl(t16a - t23a);
    t24 = cl(t31a - t24a);
    t25a = cl(t30 - t25);
    const T t26_ = cl(t29a - t26a);
    t27a = cl(t28 - t27);
    t28a = cl(t28 + t27);
    const T t29b = cl(t29a + t26a);
    t30a = cl(t30 + t25);
    t31 = cl(t31a + t24a);
    t18 = t18_;
    t21 = t21_;
    t26 = t26_;
    t29 = t29b;

    t20 = r181<T>(t27a - t20a);
    t27 = r181<T>(t27a + t20a);
    t21a = r181<T>(t26 - t21);
    t26a = r181<T>(t26 + t21);
    t22 = r181<T>(t25a - t22a);
    t25 = r181<T>(t25a + t22a);
    t23a = r181<T>(t24 - t23);
    t24a = r181<T>(t24 + t23);

    T e[16];
    for (int k = 0; k < 16; k++) e[k] = c[2 * k * s];
    const T odd[16] = {t31, t30a, t29, t28a, t27, t26a, t25, t24a,
                       t23a, t22, t21a, t20, t19a, t18, t17a, t16};
    for (int k = 0; k < 16; k++) {
        c[k * s] = cl(e[k] + odd[k]);
        c[(31 - k) * s] = cl(e[k] - odd[k]);
    }
}

// The 64-point DCT of a block whose inputs 32..63 are zero (64-point
// transforms are zero-extended from 32 coefficients): the odd half's
// first rotations take one input each.
template <typename T>
ITX_FN void dct64(T* c, int s, Clip<T> cl) {
    dct32<T>(c, 2 * s, cl);
    const T in1 = c[1 * s], in3 = c[3 * s], in5 = c[5 * s], in7 = c[7 * s];
    const T in9 = c[9 * s], in11 = c[11 * s], in13 = c[13 * s],
            in15 = c[15 * s];
    const T in17 = c[17 * s], in19 = c[19 * s], in21 = c[21 * s],
            in23 = c[23 * s];
    const T in25 = c[25 * s], in27 = c[27 * s], in29 = c[29 * s],
            in31 = c[31 * s];

    T t32a = (in1 * 101 + 2048) >> 12;
    T t33a = (in31 * -2824 + 2048) >> 12;
    T t34a = (in17 * 1660 + 2048) >> 12;
    T t35a = (in15 * -1474 + 2048) >> 12;
    T t36a = (in9 * 897 + 2048) >> 12;
    T t37a = (in23 * -2191 + 2048) >> 12;
    T t38a = (in25 * 2359 + 2048) >> 12;
    T t39a = (in7 * -700 + 2048) >> 12;
    T t40a = (in5 * 501 + 2048) >> 12;
    T t41a = (in27 * -2520 + 2048) >> 12;
    T t42a = (in21 * 2019 + 2048) >> 12;
    T t43a = (in11 * -1092 + 2048) >> 12;
    T t44a = (in13 * 1285 + 2048) >> 12;
    T t45a = (in19 * -1842 + 2048) >> 12;
    T t46a = (in29 * 2675 + 2048) >> 12;
    T t47a = (in3 * -301 + 2048) >> 12;
    T t48a = (in3 * 4085 + 2048) >> 12;
    T t49a = (in29 * 3102 + 2048) >> 12;
    T t50a = (in19 * 3659 + 2048) >> 12;
    T t51a = (in13 * 3889 + 2048) >> 12;
    T t52a = (in11 * 3948 + 2048) >> 12;
    T t53a = (in21 * 3564 + 2048) >> 12;
    T t54a = (in27 * 3229 + 2048) >> 12;
    T t55a = (in5 * 4065 + 2048) >> 12;
    T t56a = (in7 * 4036 + 2048) >> 12;
    T t57a = (in25 * 3349 + 2048) >> 12;
    T t58a = (in23 * 3461 + 2048) >> 12;
    T t59a = (in9 * 3996 + 2048) >> 12;
    T t60a = (in15 * 3822 + 2048) >> 12;
    T t61a = (in17 * 3745 + 2048) >> 12;
    T t62a = (in31 * 2967 + 2048) >> 12;
    T t63a = (in1 * 4095 + 2048) >> 12;

    T t32 = cl(t32a + t33a);
    T t33 = cl(t32a - t33a);
    T t34 = cl(t35a - t34a);
    T t35 = cl(t35a + t34a);
    T t36 = cl(t36a + t37a);
    T t37 = cl(t36a - t37a);
    T t38 = cl(t39a - t38a);
    T t39 = cl(t39a + t38a);
    T t40 = cl(t40a + t41a);
    T t41 = cl(t40a - t41a);
    T t42 = cl(t43a - t42a);
    T t43 = cl(t43a + t42a);
    T t44 = cl(t44a + t45a);
    T t45 = cl(t44a - t45a);
    T t46 = cl(t47a - t46a);
    T t47 = cl(t47a + t46a);
    T t48 = cl(t48a + t49a);
    T t49 = cl(t48a - t49a);
    T t50 = cl(t51a - t50a);
    T t51 = cl(t51a + t50a);
    T t52 = cl(t52a + t53a);
    T t53 = cl(t52a - t53a);
    T t54 = cl(t55a - t54a);
    T t55 = cl(t55a + t54a);
    T t56 = cl(t56a + t57a);
    T t57 = cl(t56a - t57a);
    T t58 = cl(t59a - t58a);
    T t59 = cl(t59a + t58a);
    T t60 = cl(t60a + t61a);
    T t61 = cl(t60a - t61a);
    T t62 = cl(t63a - t62a);
    T t63 = cl(t63a + t62a);

    t33a = rr<T>(t33, -4076, t62, 401);
    t34a = rr<T>(t34, -401, t61, -4076);
    t37a = rr<T>(t37, -2598, t58, 3166);
    t38a = rr<T>(t38, -3166, t57, -2598);
    t41a = rr<T>(t41, -3612, t54, 1931);
    t42a = rr<T>(t42, -1931, t53, -3612);
    t45a = rr<T>(t45, -1189, t50, 3920);
    t46a = rr<T>(t46, -3920, t49, -1189);
    t49a = rr<T>(t46, -1189, t49, 3920);
    t50a = rr<T>(t45, 3920, t50, 1189);
    t53a = rr<T>(t42, -3612, t53, 1931);
    t54a = rr<T>(t41, 1931, t54, 3612);
    t57a = rr<T>(t38, -2598, t57, 3166);
    t58a = rr<T>(t37, 3166, t58, 2598);
    t61a = rr<T>(t34, -4076, t61, 401);
    t62a = rr<T>(t33, 401, t62, 4076);

    t32a = cl(t32 + t35);
    t33 = cl(t33a + t34a);
    t34 = cl(t33a - t34a);
    t35a = cl(t32 - t35);
    t36a = cl(t39 - t36);
    t37 = cl(t38a - t37a);
    t38 = cl(t38a + t37a);
    t39a = cl(t39 + t36);
    t40a = cl(t40 + t43);
    t41 = cl(t41a + t42a);
    t42 = cl(t41a - t42a);
    t43a = cl(t40 - t43);
    t44a = cl(t47 - t44);
    t45 = cl(t46a - t45a);
    t46 = cl(t46a + t45a);
    t47a = cl(t47 + t44);
    t48a = cl(t48 + t51);
    t49 = cl(t49a + t50a);
    t50 = cl(t49a - t50a);
    t51a = cl(t48 - t51);
    t52a = cl(t55 - t52);
    t53 = cl(t54a - t53a);
    t54 = cl(t54a + t53a);
    t55a = cl(t55 + t52);
    t56a = cl(t56 + t59);
    t57 = cl(t57a + t58a);
    t58 = cl(t57a - t58a);
    t59a = cl(t56 - t59);
    t60a = cl(t63 - t60);
    t61 = cl(t62a - t61a);
    t62 = cl(t62a + t61a);
    t63a = cl(t63 + t60);

    t34a = rr<T>(t34, -4017, t61, 799);
    const T t35_ = rr<T>(t35a, -4017, t60a, 799);
    const T t36_ = rr<T>(t36a, -799, t59a, -4017);
    t37a = rr<T>(t37, -799, t58, -4017);
    t42a = rr<T>(t42, -2276, t53, 3406);
    const T t43_ = rr<T>(t43a, -2276, t52a, 3406);
    const T t44_ = rr<T>(t44a, -3406, t51a, -2276);
    t45a = rr<T>(t45, -3406, t50, -2276);
    t50a = rr<T>(t45, -2276, t50, 3406);
    const T t51_ = rr<T>(t44a, -2276, t51a, 3406);
    const T t52_ = rr<T>(t43a, 3406, t52a, 2276);
    t53a = rr<T>(t42, 3406, t53, 2276);
    t58a = rr<T>(t37, -4017, t58, 799);
    const T t59_ = rr<T>(t36a, -4017, t59a, 799);
    const T t60_ = rr<T>(t35a, 799, t60a, 4017);
    t61a = rr<T>(t34, 799, t61, 4017);
    t35 = t35_;
    t36 = t36_;
    t43 = t43_;
    t44 = t44_;
    t50 = t50a;
    t51 = t51_;
    t52 = t52_;
    t59 = t59_;
    t60 = t60_;

    t32 = cl(t32a + t39a);
    t33a = cl(t33 + t38);
    const T t34_ = cl(t34a + t37a);
    t35a = cl(t35 + t36);
    t36a = cl(t35 - t36);
    const T t37_ = cl(t34a - t37a);
    t38a = cl(t33 - t38);
    t39 = cl(t32a - t39a);
    t40 = cl(t47a - t40a);
    t41a = cl(t46 - t41);
    const T t42_ = cl(t45a - t42a);
    t43a = cl(t44 - t43);
    t44a = cl(t44 + t43);
    const T t45_ = cl(t45a + t42a);
    t46a = cl(t46 + t41);
    t47 = cl(t47a + t40a);
    t48 = cl(t48a + t55a);
    t49a = cl(t49 + t54);
    const T t50_ = cl(t50 + t53a);
    t51a = cl(t51 + t52);
    t52a = cl(t51 - t52);
    const T t53_ = cl(t50 - t53a);
    t54a = cl(t49 - t54);
    t55 = cl(t48a - t55a);
    t56 = cl(t63a - t56a);
    t57a = cl(t62 - t57);
    const T t58_ = cl(t61a - t58a);
    t59a = cl(t60 - t59);
    t60a = cl(t60 + t59);
    const T t61_ = cl(t61a + t58a);
    t62a = cl(t62 + t57);
    t63 = cl(t63a + t56a);
    t34 = t34_;
    t37 = t37_;
    t42 = t42_;
    t45 = t45_;
    t50 = t50_;
    t53 = t53_;
    t58 = t58_;
    t61 = t61_;

    t36 = rr<T>(t36a, -3784, t59a, 1567);
    t37a = rr<T>(t37, -3784, t58, 1567);
    const T t38_ = rr<T>(t38a, -3784, t57a, 1567);
    t39a = rr<T>(t39, -3784, t56, 1567);
    t40a = rr<T>(t40, -1567, t55, -3784);
    const T t41_ = rr<T>(t41a, -1567, t54a, -3784);
    t42a = rr<T>(t42, -1567, t53, -3784);
    const T t43b = rr<T>(t43a, -1567, t52a, -3784);
    const T t52b = rr<T>(t43a, -3784, t52a, 1567);
    t53a = rr<T>(t42, -3784, t53, 1567);
    const T t54_ = rr<T>(t41a, -3784, t54a, 1567);
    t55a = rr<T>(t40, -3784, t55, 1567);
    t56a = rr<T>(t39, 1567, t56, 3784);
    const T t57_ = rr<T>(t38a, 1567, t57a, 3784);
    t58a = rr<T>(t37, 1567, t58, 3784);
    const T t59b = rr<T>(t36a, 1567, t59a, 3784);
    t38 = t38_;
    t41 = t41_;
    t43 = t43b;
    t52 = t52b;
    t54 = t54_;
    t57 = t57_;
    t59 = t59b;

    t32a = cl(t32 + t47);
    const T t33_ = cl(t33a + t46a);
    t34a = cl(t34 + t45);
    const T t35b = cl(t35a + t44a);
    t36a = cl(t36 + t43);
    const T t37b = cl(t37a + t42a);
    t38a = cl(t38 + t41);
    const T t39_ = cl(t39a + t40a);
    const T t40_ = cl(t39a - t40a);
    t41a = cl(t38 - t41);
    const T t42b = cl(t37a - t42a);
    t43a = cl(t36 - t43);
    const T t44b = cl(t35a - t44a);
    t45a = cl(t34 - t45);
    const T t46_ = cl(t33a - t46a);
    t47a = cl(t32 - t47);
    t48a = cl(t63 - t48);
    const T t49_ = cl(t62a - t49a);
    t50a = cl(t61 - t50);
    const T t51b = cl(t60a - t51a);
    t52a = cl(t59 - t52);
    const T t53b = cl(t58a - t53a);
    t54a = cl(t57 - t54);
    const T t55_ = cl(t56a - t55a);
    const T t56_ = cl(t56a + t55a);
    t57a = cl(t57 + t54);
    const T t58b = cl(t58a + t53a);
    t59a = cl(t59 + t52);
    const T t60b = cl(t60a + t51a);
    t61a = cl(t61 + t50);
    const T t62_ = cl(t62a + t49a);
    t63a = cl(t63 + t48);
    t33 = t33_;
    t35 = t35b;
    t37 = t37b;
    t39 = t39_;
    t40 = t40_;
    t42 = t42b;
    t44 = t44b;
    t46 = t46_;
    t49 = t49_;
    t51 = t51b;
    t53 = t53b;
    t55 = t55_;
    t56 = t56_;
    t58 = t58b;
    t60 = t60b;
    t62 = t62_;

    t40a = r181<T>(t55 - t40);
    const T t41b = r181<T>(t54a - t41a);
    t42a = r181<T>(t53 - t42);
    const T t43c = r181<T>(t52a - t43a);
    t44a = r181<T>(t51 - t44);
    const T t45b = r181<T>(t50a - t45a);
    t46a = r181<T>(t49 - t46);
    const T t47_ = r181<T>(t48a - t47a);
    const T t48_ = r181<T>(t47a + t48a);
    t49a = r181<T>(t46 + t49);
    const T t50b = r181<T>(t45a + t50a);
    t51a = r181<T>(t44 + t51);
    const T t52c = r181<T>(t43a + t52a);
    t53a = r181<T>(t42 + t53);
    const T t54b = r181<T>(t41a + t54a);
    t55a = r181<T>(t40 + t55);
    t41 = t41b;
    t43 = t43c;
    t45 = t45b;
    t47 = t47_;
    t48 = t48_;
    t50 = t50b;
    t52 = t52c;
    t54 = t54b;

    T e[32];
    for (int k = 0; k < 32; k++) e[k] = c[2 * k * s];
    const T odd[32] = {t63a, t62, t61a, t60, t59a, t58, t57a, t56,
                       t55a, t54, t53a, t52, t51a, t50, t49a, t48,
                       t47, t46a, t45, t44a, t43, t42a, t41, t40a,
                       t39, t38a, t37, t36a, t35, t34a, t33, t32a};
    for (int k = 0; k < 32; k++) {
        c[k * s] = cl(e[k] + odd[k]);
        c[(63 - k) * s] = cl(e[k] - odd[k]);
    }
}

// ---- ADST (out may be the input reversed: flipadst) ---------------------

template <typename T>
ITX_FN void adst4(const T* in, int si, T* out, int so) {
    const T in0 = in[0], in1 = in[si], in2 = in[2 * si], in3 = in[3 * si];
    out[0 * so] = (1321 * in0 + 3803 * in2 + 2482 * in3 + 3344 * in1 +
                   2048) >> 12;
    out[1 * so] = (2482 * in0 - 1321 * in2 - 3803 * in3 + 3344 * in1 +
                   2048) >> 12;
    out[2 * so] = (209 * (in0 - in2 + in3) + 128) >> 8;
    out[3 * so] = (3803 * in0 + 2482 * in2 - 1321 * in3 - 3344 * in1 +
                   2048) >> 12;
}

template <typename T>
ITX_FN void adst8(const T* in, int si, T* out, int so, Clip<T> cl) {
    const T in0 = in[0], in1 = in[si], in2 = in[2 * si], in3 = in[3 * si];
    const T in4 = in[4 * si], in5 = in[5 * si], in6 = in[6 * si],
            in7 = in[7 * si];
    T t0a = rr<T>(in7, 4076, in0, 401);
    T t1a = rr<T>(in7, 401, in0, -4076);
    T t2a = rr<T>(in5, 3612, in2, 1931);
    T t3a = rr<T>(in5, 1931, in2, -3612);
    T t4a = rr<T>(in3, 2598, in4, 3166);
    T t5a = rr<T>(in3, 3166, in4, -2598);
    T t6a = rr<T>(in1, 1189, in6, 3920);
    T t7a = rr<T>(in1, 3920, in6, -1189);

    const T t0 = cl(t0a + t4a);
    const T t1 = cl(t1a + t5a);
    T t2 = cl(t2a + t6a);
    T t3 = cl(t3a + t7a);
    const T t4 = cl(t0a - t4a);
    const T t5 = cl(t1a - t5a);
    T t6 = cl(t2a - t6a);
    T t7 = cl(t3a - t7a);

    t4a = rr<T>(t4, 3784, t5, 1567);
    t5a = rr<T>(t4, 1567, t5, -3784);
    t6a = rr<T>(t7, 3784, t6, -1567);
    t7a = rr<T>(t7, 1567, t6, 3784);

    out[0 * so] = cl(t0 + t2);
    out[7 * so] = -cl(t1 + t3);
    t2 = cl(t0 - t2);
    t3 = cl(t1 - t3);
    out[1 * so] = -cl(t4a + t6a);
    out[6 * so] = cl(t5a + t7a);
    t6 = cl(t4a - t6a);
    t7 = cl(t5a - t7a);

    out[3 * so] = -r181<T>(t2 + t3);
    out[4 * so] = r181<T>(t2 - t3);
    out[2 * so] = r181<T>(t6 + t7);
    out[5 * so] = -r181<T>(t6 - t7);
}

template <typename T>
ITX_FN void adst16(const T* in, int si, T* out, int so, Clip<T> cl) {
    T v[16];
    for (int k = 0; k < 16; k++) v[k] = in[k * si];
    const T in0 = v[0], in1 = v[1], in2 = v[2], in3 = v[3], in4 = v[4],
            in5 = v[5], in6 = v[6], in7 = v[7], in8 = v[8], in9 = v[9],
            in10 = v[10], in11 = v[11], in12 = v[12], in13 = v[13],
            in14 = v[14], in15 = v[15];

    T t0 = rr<T>(in15, 4091, in0, 201);
    T t1 = rr<T>(in15, 201, in0, -4091);
    T t2 = rr<T>(in13, 3973, in2, 995);
    T t3 = rr<T>(in13, 995, in2, -3973);
    T t4 = rr<T>(in11, 3703, in4, 1751);
    T t5 = rr<T>(in11, 1751, in4, -3703);
    T t6 = rr<T>(in9, 3290, in6, 2440);
    T t7 = rr<T>(in9, 2440, in6, -3290);
    T t8 = rr<T>(in7, 2751, in8, 3035);
    T t9 = rr<T>(in7, 3035, in8, -2751);
    T t10 = rr<T>(in5, 2106, in10, 3513);
    T t11 = rr<T>(in5, 3513, in10, -2106);
    T t12 = rr<T>(in3, 1380, in12, 3857);
    T t13 = rr<T>(in3, 3857, in12, -1380);
    T t14 = rr<T>(in1, 601, in14, 4052);
    T t15 = rr<T>(in1, 4052, in14, -601);

    T t0a = cl(t0 + t8);
    T t1a = cl(t1 + t9);
    T t2a = cl(t2 + t10);
    T t3a = cl(t3 + t11);
    T t4a = cl(t4 + t12);
    T t5a = cl(t5 + t13);
    T t6a = cl(t6 + t14);
    T t7a = cl(t7 + t15);
    T t8a = cl(t0 - t8);
    T t9a = cl(t1 - t9);
    T t10a = cl(t2 - t10);
    T t11a = cl(t3 - t11);
    T t12a = cl(t4 - t12);
    T t13a = cl(t5 - t13);
    T t14a = cl(t6 - t14);
    T t15a = cl(t7 - t15);

    t8 = rr<T>(t8a, 4017, t9a, 799);
    t9 = rr<T>(t8a, 799, t9a, -4017);
    t10 = rr<T>(t10a, 2276, t11a, 3406);
    t11 = rr<T>(t10a, 3406, t11a, -2276);
    t12 = rr<T>(t13a, 4017, t12a, -799);
    t13 = rr<T>(t13a, 799, t12a, 4017);
    t14 = rr<T>(t15a, 2276, t14a, -3406);
    t15 = rr<T>(t15a, 3406, t14a, 2276);

    t0 = cl(t0a + t4a);
    t1 = cl(t1a + t5a);
    t2 = cl(t2a + t6a);
    t3 = cl(t3a + t7a);
    t4 = cl(t0a - t4a);
    t5 = cl(t1a - t5a);
    t6 = cl(t2a - t6a);
    t7 = cl(t3a - t7a);
    t8a = cl(t8 + t12);
    t9a = cl(t9 + t13);
    t10a = cl(t10 + t14);
    t11a = cl(t11 + t15);
    t12a = cl(t8 - t12);
    t13a = cl(t9 - t13);
    t14a = cl(t10 - t14);
    t15a = cl(t11 - t15);

    t4a = rr<T>(t4, 3784, t5, 1567);
    t5a = rr<T>(t4, 1567, t5, -3784);
    t6a = rr<T>(t7, 3784, t6, -1567);
    t7a = rr<T>(t7, 1567, t6, 3784);
    t12 = rr<T>(t12a, 3784, t13a, 1567);
    t13 = rr<T>(t12a, 1567, t13a, -3784);
    t14 = rr<T>(t15a, 3784, t14a, -1567);
    t15 = rr<T>(t15a, 1567, t14a, 3784);

    out[0 * so] = cl(t0 + t2);
    out[15 * so] = -cl(t1 + t3);
    t2a = cl(t0 - t2);
    t3a = cl(t1 - t3);
    out[3 * so] = -cl(t4a + t6a);
    out[12 * so] = cl(t5a + t7a);
    t6 = cl(t4a - t6a);
    t7 = cl(t5a - t7a);
    out[1 * so] = -cl(t8a + t10a);
    out[14 * so] = cl(t9a + t11a);
    t10 = cl(t8a - t10a);
    t11 = cl(t9a - t11a);
    out[2 * so] = cl(t12 + t14);
    out[13 * so] = -cl(t13 + t15);
    t14a = cl(t12 - t14);
    t15a = cl(t13 - t15);

    out[7 * so] = -r181<T>(t2a + t3a);
    out[8 * so] = r181<T>(t2a - t3a);
    out[4 * so] = r181<T>(t6 + t7);
    out[11 * so] = -r181<T>(t6 - t7);
    out[6 * so] = r181<T>(t10 + t11);
    out[9 * so] = -r181<T>(t10 - t11);
    out[5 * so] = -r181<T>(t14a + t15a);
    out[10 * so] = r181<T>(t14a - t15a);
}

// ---- identity and WHT (no clip) -----------------------------------------

template <typename T>
ITX_FN void identity(T* c, int s, int n) {
    for (int i = 0; i < n; i++) {
        const T v = c[i * s];
        if (n == 4)
            c[i * s] = v + ((v * 1697 + 2048) >> 12);
        else if (n == 8)
            c[i * s] = v * 2;
        else if (n == 16)
            c[i * s] = 2 * v + ((v * 1697 + 1024) >> 11);
        else
            c[i * s] = v * 4;
    }
}

template <typename T>
ITX_FN void wht4(T* c, int s) {
    const T in0 = c[0], in1 = c[s], in2 = c[2 * s], in3 = c[3 * s];
    const T t0 = in0 + in1;
    const T t2 = in2 - in3;
    const T t4 = (t0 - t2) >> 1;
    const T t3 = t4 - in3;
    const T t1 = t4 - in1;
    c[0] = t0 - t3;
    c[s] = t3;
    c[2 * s] = t1;
    c[3 * s] = t2 + t1;
}

// The 1-D transform of length 4 << lsz and type `type` on c[0], c[s], ...
// (recon/itx.py _1D_FNS); the caller has checked that the pair exists.
// Not inlined on the device: the row pass (stride S) and the column
// pass (stride 1) share one copy of the transforms, and the kernel's
// code, which runs cold in a decode, is about half as large (PERF.md).
template <typename T>
ITX_NOINLINE void tx1d(T* c, int s, int lsz, int type, Clip<T> cl) {
    const int n = 4 << lsz;
    if (type == DCT) {
        switch (lsz) {
            case 0: dct4<T>(c, s, cl); break;
            case 1: dct8<T>(c, s, cl); break;
            case 2: dct16<T>(c, s, cl); break;
            case 3: dct32<T>(c, s, cl); break;
            default: dct64<T>(c, s, cl); break;
        }
    } else if (type == IDENTITY) {
        identity<T>(c, s, n);
    } else {
        T* out = type == FLIPADST ? c + (n - 1) * s : c;
        const int so = type == FLIPADST ? -s : s;
        switch (lsz) {
            case 0: adst4<T>(c, s, out, so); break;
            case 1: adst8<T>(c, s, out, so, cl); break;
            default: adst16<T>(c, s, out, so, cl); break;
        }
    }
}

// ---- a group of jobs, in four phases ------------------------------------
//
// The schedule (ops/itx.py group_list) cuts the job list, sorted by tx
// size, into groups of consecutive jobs of one tx size: LANES / w jobs
// of width w, so that the column pass has one lane per column (16 4x4
// jobs, 8 8x8, 4 16x16, 2 32x32, one 64-wide job).  One CTA of LANES
// threads runs one group.  Between two phases the caller synchronises
// its threads; within a phase thread `tid` of `nt` writes only what it
// owns.
//
// The tile holds each job's sw x sh coefficients widened to w x sh,
// column-major: element (x, y) of job j at (j * w + x) * S + y, with a
// column stride S = sh + 1.  A column is contiguous, so the column pass
// runs in place with stride 1, and lanes on neighbouring columns (of
// one job or of neighbouring jobs) are S words apart, S odd: the column
// pass has no bank conflicts.  The load reads the column-major
// coefficient window in order, neighbouring lanes on neighbouring
// words, and transposes nothing: the window's [x][y] order is the
// tile's, one padding word a column apart (the row pass reads across
// columns, S apart).  A group's tile is LANES * (sh + 1) elements, at
// most LANES * 33: 8,448 B at 8/10-bit, 16,896 B at 12-bit.  A 64-row
// column (sh is 32) is transformed in registers and stored from there:
// in place in a tile of 65 rows a column it ran slower (PERF.md).
//
// Zero rows.  A coded row whose coefficients are all zero leaves the
// row pass as zeros: every step of every 1-D transform of the codec
// (DCT, ADST, FLIPADST, IDENTITY, WHT) maps zeros to zero — sums and
// differences, the rotations (0*a + 0*b + 2048) >> 12, (0*181+128) >> 8,
// the identity scalings, WHT's halving — as do the rect2 pre-scale
// (0*181+128) >> 8, WHT's cf >> 2, the rounding (0 + rnd) >> shift with
// rnd < 2^shift, and both clips.  So the load records a flag per coded
// row (bit y of the job's row mask) for each row holding a nonzero value,
// and the row pass transforms only the flagged rows, dealt out to the
// CTA's lanes in turn; the other rows stay 0.  A flag per row, not a
// count of leading rows: a nonzero row may follow zero rows.  The column
// pass runs every column.

constexpr int LANES = 64;             // threads of the kernel's CTA
constexpr int MAX_JOBS = LANES / 4;   // a group of 4-wide jobs
constexpr int TILE_ELEMS = LANES * 33;

// Columns of a group row (int32, ops/itx.py group_list): first job, job
// count, their tx size.
constexpr int GROUP_COLS = 3;
constexpr int G_FIRST = 0, G_COUNT = 1, G_TX = 2;

#ifdef __CUDACC__
#define ITX_POPC(v) __popc(v)
#define ITX_CTZ(v) (__ffs((int)(v)) - 1)
#define ITX_OR(p, v) atomicOr((p), (v))
#else
#define ITX_POPC(v) __builtin_popcount(v)
#define ITX_CTZ(v) __builtin_ctz(v)
#define ITX_OR(p, v) (*(p) |= (v))
#endif

// A group's tx size and job count.
struct Size {
    int tx, w, h, lw, lh, lsh, sw, sh, S, shift, n;
    bool rect2;
};

// `count` jobs of size `tx`.  A group row that ops/itx.py group_list
// cannot make — a tx size out of range, no job, more than the LANES / w
// jobs a group holds — stops the kernel (a launch failure on the host),
// as does a job of another tx size in setup: the tile and the group's
// job arrays are sized for what group_list makes.
ITX_FN Size size_of(int tx, int count) {
    if (tx < 0 || tx >= N_TX) ITX_TRAP();
    Size z;
    z.tx = tx;
    z.lw = TX_LW[tx];
    z.lh = TX_LH[tx];
    z.w = 4 << z.lw;
    z.h = 4 << z.lh;
    z.lsh = z.lh < 3 ? z.lh : 3;
    z.sw = z.w < 32 ? z.w : 32;
    z.sh = 4 << z.lsh;
    z.S = z.sh + 1;
    z.shift = TX_SHIFT[tx];
    z.rect2 = z.lw - z.lh == 1 || z.lh - z.lw == 1;
    if (count < 1 || count > LANES >> (z.lw + 2)) ITX_TRAP();
    z.n = count;
    return z;
}

// Row and column clips of the bit depth (recon/itx.py itx_add).
template <typename T>
ITX_FN void clips(int bitdepth, Clip<T>& row, Clip<T>& col) {
    if (bitdepth == 8) {
        row.lo = col.lo = -(T(1) << 15);
    } else {
        row.lo = -(T(1) << (bitdepth + 7));
        col.lo = -(T(1) << (bitdepth + 5));
    }
    row.hi = ~row.lo;
    col.hi = ~col.lo;
}

// A CTA's shared memory: the tile and its jobs' rows.
template <typename T>
struct Group {
    T tile[TILE_ELEMS];
    int cf[MAX_JOBS], out[MAX_JOBS], txtp[MAX_JOBS];
    unsigned rows[MAX_JOBS];  // bit y: coded row y holds a nonzero value
};

// Phase 0: the group's job rows (jobs first .. first + n - 1), each of
// the group's tx size, and the row masks cleared.
template <typename T>
ITX_FN void setup(Group<T>& s, const int* jobs, int first, const Size& z,
                  int tid, int nt) {
    for (int j = tid; j < z.n; j += nt) {
        const int* J = jobs + (long long)(first + j) * JOB_COLS;
        if (J[J_TX] != z.tx) ITX_TRAP();
        s.cf[j] = J[J_CF];
        s.out[j] = J[J_OUT];
        s.txtp[j] = J[J_TXTP];
        s.rows[j] = 0;
    }
}

// Phase 1: each job's sw x sh coefficients ([x][y]) in window order into
// the tile, columns sw.. zero; WHT_WHT takes cf >> 2, a 2:1 block the
// rect2 pre-scale; the row flags.  A lane issues LOAD_BATCH loads before
// it stores any, so that their latencies overlap.
constexpr int LOAD_BATCH = 16;

template <typename T>
ITX_FN void load(Group<T>& s, const int* cf, const Size& z, int tid,
                 int nt) {
    const int lcol = z.lsh + 2, lper = z.lw + 2 + lcol;
    const int total = z.n << lper, kmask = (1 << lper) - 1;
    for (int i0 = tid; i0 < total; i0 += nt * LOAD_BATCH) {
        T v[LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; u++) {
            const int i = i0 + u * nt, k = i & kmask;
            // window element x * sh + y = k, for x < sw
            v[u] = i < total && (k >> lcol) < z.sw
                       ? T(cf[s.cf[i >> lper] + k]) : T(0);
        }
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; u++) {
            const int i = i0 + u * nt;
            if (i >= total) break;
            const int j = i >> lper, k = i & kmask;
            const int x = k >> lcol, y = k & (z.sh - 1);
            T c = v[u];
            if (s.txtp[j] == WHT_WHT)
                c >>= 2;
            else if (z.rect2)
                c = r181<T>(c);
            s.tile[((j << (z.lw + 2)) + x) * z.S + y] = c;
            if (c != 0) ITX_OR(&s.rows[j], 1u << y);
        }
    }
}

// Phase 2: the row transform of each flagged row, then the rounding
// shift and the column clip; lane tid takes flagged rows tid, tid + nt,
// ... of the group, counted job by job.
template <typename T>
ITX_FN void rows(Group<T>& s, const Size& z, Clip<T> rcl, Clip<T> ccl,
                 int tid, int nt) {
    int total = 0;
    for (int j = 0; j < z.n; j++) total += ITX_POPC(s.rows[j]);
    const T rnd = (T(1) << z.shift) >> 1;
    for (int r = tid; r < total; r += nt) {
        int j = 0, k = r;  // flagged row k of job j
        for (int c; k >= (c = ITX_POPC(s.rows[j])); j++) k -= c;
        unsigned m = s.rows[j];
        for (; k > 0; k--) m &= m - 1;  // drop the k lowest flags
        T* c = s.tile + (j << (z.lw + 2)) * z.S + ITX_CTZ(m);
        const int tp = s.txtp[j];
        if (tp == WHT_WHT) {
            wht4<T>(c, z.S);
            continue;
        }
        tx1d<T>(c, z.S, z.lw, TX_ROW_T[tp], rcl);
#pragma unroll 4
        for (int x = 0; x < z.w; x++)
            c[x * z.S] = ccl((c[x * z.S] + rnd) >> z.shift);
    }
}

// Phase 3: the column transform of each column with the column clip,
// and its residuals, (v + 8) >> 4 (WHT_WHT: v), stored row-major at the
// job's offset, narrowed to O.
template <typename T, typename O>
ITX_FN void cols(Group<T>& s, const Size& z, Clip<T> ccl, O* out, int tid,
                 int nt) {
    for (int i = tid; i < z.n << (z.lw + 2); i += nt) {
        const int j = i >> (z.lw + 2), x = i & (z.w - 1);
        T* c = s.tile + i * z.S;
        O* o = out + s.out[j] + x;
        const int tp = s.txtp[j];
        if (tp == WHT_WHT) {
            wht4<T>(c, 1);
            for (int y = 0; y < 4; y++) o[y * 4] = (O)c[y];
        } else if (z.lh == 4) {  // 64 rows: DCT only; inputs 32.. zero
            T col[64];
#pragma unroll
            for (int y = 0; y < 64; y++) col[y] = y < 32 ? c[y] : T(0);
            dct64<T>(col, 1, ccl);
#pragma unroll
            for (int y = 0; y < 64; y++)
                o[y * z.w] = (O)((col[y] + 8) >> 4);
        } else {
            tx1d<T>(c, 1, z.lh, TX_COL_T[tp], ccl);
#pragma unroll 4
            for (int y = 0; y < z.h; y++) o[y * z.w] = (O)((c[y] + 8) >> 4);
        }
    }
}

}  // namespace itx
