// Native host kernels for the serial per-join hot path.
//
// The progressive/refinement loop is a serial chain of profile-pair
// alignments; its host-side costs are the MEA DP + traceback and the
// column-posterior scatter accumulation (reference equivalents:
// CalcAlnFlat src/calcalnflat.cpp, TraceBackFlat src/tracebackflat.cpp,
// BuildPost src/buildpostflat.cpp). These C++ kernels replace the numpy
// row loops; exposed via ctypes (muscle_tpu_torch/native/__init__.py).
//
// Tie-breaking matches Best3 (src/best3.h): B >= X >= Y.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// MEA DP + traceback.
// post: lx*ly row-major posteriors. path_out: caller-allocated buffer of
// at least lx+ly bytes; receives 'B'/'X'/'Y' chars. Returns path length,
// or -1 on error. score_out receives the DP score.
// tb: caller-allocated lx*ly bytes of scratch for direction codes.
int64_t mea_align(const float* post, int64_t lx, int64_t ly,
                  float* rows, uint8_t* tb, char* path_out,
                  float* score_out)
    {
    float* oldr = rows;            // ly+1 floats
    float* newr = rows + (ly + 1);
    for (int64_t j = 0; j <= ly; ++j)
        oldr[j] = 0.0f;

    for (int64_t i = 0; i < lx; ++i)
        {
        const float* p = post + i * ly;
        uint8_t* trow = tb + i * ly;
        newr[0] = 0.0f;
        float left = 0.0f;
        for (int64_t j = 0; j < ly; ++j)
            {
            float b = oldr[j] + p[j];
            float x = oldr[j + 1];
            float best;
            uint8_t dir;
            if (b >= x)
                {
                if (b >= left) { best = b; dir = 0; }   // B
                else           { best = left; dir = 2; } // Y
                }
            else if (x >= left) { best = x; dir = 1; }   // X
            else                { best = left; dir = 2; }
            newr[j + 1] = best;
            trow[j] = dir;
            left = best;
            }
        std::swap(oldr, newr);
        }
    *score_out = oldr[ly];

    // traceback from (lx, ly)
    int64_t i = lx, j = ly;
    int64_t n = 0;
    char* rev = path_out;          // fill reversed, then reverse in place
    while (i > 0 || j > 0)
        {
        char c;
        if (i == 0)      { c = 'Y'; --j; }
        else if (j == 0) { c = 'X'; --i; }
        else
            {
            uint8_t d = tb[(i - 1) * ly + (j - 1)];
            if (d == 0)      { c = 'B'; --i; --j; }
            else if (d == 1) { c = 'X'; --i; }
            else             { c = 'Y'; --j; }
            }
        rev[n++] = c;
        }
    for (int64_t k = 0; k < n / 2; ++k)
        std::swap(rev[k], rev[n - 1 - k]);
    return n;
    }

// Column-posterior accumulation: out[ptc1[i]*cc2 + ptc2[j]] += P[i*ly+j]
// for all (i, j). reference: BuildPost inner loops
// (src/buildpostflat.cpp:60-100).
void build_post_accumulate(float* out, int64_t cc2,
                           const float* P, int64_t lx, int64_t ly,
                           const uint32_t* ptc1, const uint32_t* ptc2)
    {
    for (int64_t i = 0; i < lx; ++i)
        {
        float* orow = out + (int64_t)ptc1[i] * cc2;
        const float* prow = P + i * ly;
        for (int64_t j = 0; j < ly; ++j)
            {
            float v = prow[j];
            if (v != 0.0f)
                orow[ptc2[j]] += v;
            }
        }
    }

// Sparse column-posterior accumulation from the fixed-K row layout
// (muscle_tpu_torch/ops/sparse.py): per stored entry (i, c, v) with c >= 0,
//   transposed == 0: out[ptc1[i]*cc2 + ptc2[c]] += v
//   transposed != 0: out[ptc1[c]*cc2 + ptc2[i]] += v   (pair stored in
// the opposite orientation). reference: the same accumulation walked
// through MySparseMx offsets in BuildPost (src/buildpostflat.cpp:60-100).
void build_post_accumulate_sparse(float* out, int64_t cc2,
                                  const float* vals, const int32_t* cols,
                                  int64_t lx, int64_t k,
                                  const uint32_t* ptc1,
                                  const uint32_t* ptc2, int transposed)
    {
    if (!transposed)
        {
        for (int64_t i = 0; i < lx; ++i)
            {
            float* orow = out + (int64_t)ptc1[i] * cc2;
            const float* vrow = vals + i * k;
            const int32_t* crow = cols + i * k;
            for (int64_t m = 0; m < k; ++m)
                {
                int32_t c = crow[m];
                if (c < 0)
                    break;          // slots are packed valid-first
                orow[ptc2[c]] += vrow[m];
                }
            }
        }
    else
        {
        for (int64_t i = 0; i < lx; ++i)
            {
            const float* vrow = vals + i * k;
            const int32_t* crow = cols + i * k;
            uint32_t o2 = ptc2[i];
            for (int64_t m = 0; m < k; ++m)
                {
                int32_t c = crow[m];
                if (c < 0)
                    break;
                out[(int64_t)ptc1[c] * cc2 + o2] += vrow[m];
                }
            }
        }
    }

// CSR variant of the column-posterior accumulation: vals/cols hold the
// packed valid entries of all rows back-to-back, rowptr[i]..rowptr[i+1]
// delimiting row i (the layout of the fetched sparse store —
// pipeline/posteriors.store_to_csr; reference walks its CSR MySparseMx the same
// way, src/buildpostflat.cpp:18-106).
void build_post_accumulate_csr(float* out, int64_t cc2,
                               const float* vals, const int32_t* cols,
                               const int64_t* rowptr, int64_t lx,
                               const uint32_t* ptc1,
                               const uint32_t* ptc2, int transposed)
    {
    if (!transposed)
        {
        for (int64_t i = 0; i < lx; ++i)
            {
            float* orow = out + (int64_t)ptc1[i] * cc2;
            for (int64_t m = rowptr[i]; m < rowptr[i + 1]; ++m)
                orow[ptc2[cols[m]]] += vals[m];
            }
        }
    else
        {
        for (int64_t i = 0; i < lx; ++i)
            {
            uint32_t o2 = ptc2[i];
            for (int64_t m = rowptr[i]; m < rowptr[i + 1]; ++m)
                out[(int64_t)ptc1[cols[m]] * cc2 + o2] += vals[m];
            }
        }
    }

// Score-only MEA DP (reference: src/calcalnscoreflat.cpp).
float mea_score(const float* post, int64_t lx, int64_t ly, float* rows)
    {
    float* oldr = rows;
    float* newr = rows + (ly + 1);
    for (int64_t j = 0; j <= ly; ++j)
        oldr[j] = 0.0f;
    for (int64_t i = 0; i < lx; ++i)
        {
        const float* p = post + i * ly;
        newr[0] = 0.0f;
        float left = 0.0f;
        for (int64_t j = 0; j < ly; ++j)
            {
            float b = oldr[j] + p[j];
            float x = oldr[j + 1];
            float best = b >= x ? b : x;
            if (left > best)
                best = left;
            newr[j + 1] = best;
            left = best;
            }
        std::swap(oldr, newr);
        }
    return oldr[ly];
    }

}  // extern "C"
