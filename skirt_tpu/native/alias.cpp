// Walker alias-table construction for R discrete distributions.
//
// ref role: the reference samples its dust-emission cell CDF with
// NR::locate binary searches per packet (PanMonteCarloSimulation.cpp:303);
// the engine samples Walker alias tables instead (2 gathers/packet).
// Construction is O(N) per row (Vose's method) but pointer-chasing —
// a poor fit for numpy, so it lives here next to the Voronoi builder.

#include <cstdint>
#include <vector>

extern "C" int alias_build(const double* weights, int64_t R, int64_t N,
                           float* prob, int32_t* alias) {
    std::vector<int64_t> small;
    std::vector<int64_t> large;
    std::vector<double> p(N);
    for (int64_t r = 0; r < R; ++r) {
        const double* w = weights + r * N;
        float* pr = prob + r * N;
        int32_t* al = alias + r * N;
        double total = 0.0;
        for (int64_t i = 0; i < N; ++i) total += w[i];
        if (!(total > 0.0)) {
            for (int64_t i = 0; i < N; ++i) { pr[i] = 1.0f; al[i] = int32_t(i); }
            continue;
        }
        const double scale = double(N) / total;
        small.clear();
        large.clear();
        for (int64_t i = 0; i < N; ++i) {
            p[i] = w[i] * scale;
            al[i] = int32_t(i);
            pr[i] = 1.0f;
            (p[i] < 1.0 ? small : large).push_back(i);
        }
        while (!small.empty() && !large.empty()) {
            const int64_t s = small.back(); small.pop_back();
            const int64_t l = large.back(); large.pop_back();
            pr[s] = float(p[s]);
            al[s] = int32_t(l);
            p[l] = (p[l] + p[s]) - 1.0;
            (p[l] < 1.0 ? small : large).push_back(l);
        }
        // leftovers are 1 within roundoff
        for (int64_t i : small) pr[i] = 1.0f;
        for (int64_t i : large) pr[i] = 1.0f;
    }
    return 0;
}
